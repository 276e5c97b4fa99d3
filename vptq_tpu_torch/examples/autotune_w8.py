"""Launch-plan sweep of K1 ``w8_matmul`` at decode shapes.

The port of ``examples/autotune_w8.py``: every plan the decode GEMV
admits at each shape of :data:`~vptq_tpu_torch.examples.autotune.SWEEPS`
``["w8"]``, held to the plain version and timed on the card
(``examples/autotune.py``)::

    python -m vptq_tpu_torch.examples.autotune_w8 [--iters 30] [--device cpu]

Without a CUDA device it exits non-zero unless given ``--device cpu``
(the plans only).
"""

from vptq_tpu_torch.examples import autotune


def main(argv=None) -> list:
    return autotune.main(argv, kernel="w8")


if __name__ == "__main__":
    main()
