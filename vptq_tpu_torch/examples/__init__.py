"""Measurement entry points of the port, run on the card.

Each module is the port of the script of the same name under the JAX
package's ``examples/``: ``kernel_bench`` (K1 per decode shape and the
timer the others and ``chip_smoke.py`` share), ``w4_wall_candidates``
(P1), ``w4_unpack_ablation`` (P2) and ``vq_smallk_probe`` (P3). Run one
with ``python -m vptq_tpu_torch.examples.<name>``; without a CUDA device
it exits non-zero unless given ``--device cpu``, which runs the plain
versions on the host clock. ``kernel_turns`` (the smoke's kernel phases
of several trees, in turns) and ``sass_diff`` (the kernels' SASS of two
trees) compare versions of the kernels on one card; ``decode_splits``
times K1's and K2's decode GEMV at each cluster size beside the GEMV it
replaced. These three need a CUDA device.
"""
