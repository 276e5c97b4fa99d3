"""Launch-plan sweep of K3 ``w2_matmul`` (groups 64 and 128) at decode shapes.

The port of ``examples/autotune_w2.py``: every plan the decode GEMV
admits at each shape of :data:`~vptq_tpu_torch.examples.autotune.SWEEPS`
``["w2"]``, held to the plain version and timed on the card
(``examples/autotune.py``)::

    python -m vptq_tpu_torch.examples.autotune_w2 [--iters 30] [--device cpu]

Without a CUDA device it exits non-zero unless given ``--device cpu``
(the plans only).
"""

from vptq_tpu_torch.examples import autotune


def main(argv=None) -> list:
    return autotune.main(argv, kernel="w2")


if __name__ == "__main__":
    main()
