"""``python -m vptq_tpu_torch``: the CLI (``serving/cli.py``)."""

from vptq_tpu_torch.serving.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
