"""Launch-plan sweep of K2 ``w4_matmul`` at decode shapes.

The port of ``examples/autotune_w4.py``: every plan the decode GEMV
admits at each shape of :data:`~vptq_tpu_torch.examples.autotune.SWEEPS`
``["w4"]``, held to the plain version and timed on the card
(``examples/autotune.py``)::

    python -m vptq_tpu_torch.examples.autotune_w4 [--iters 30] [--device cpu]

Without a CUDA device it exits non-zero unless given ``--device cpu``
(the plans only).
"""

from vptq_tpu_torch.examples import autotune


def main(argv=None) -> list:
    return autotune.main(argv, kernel="w4")


if __name__ == "__main__":
    main()
