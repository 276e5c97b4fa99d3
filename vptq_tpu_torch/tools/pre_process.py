"""Offline checkpoint pre-processing CLI.

Port of ``vptq_tpu/tools/pre_process.py``, parity with ``python -m
vptq.tools.pre_process`` (reference: vptq/tools/pre_process.py:23-94):
absorb permutations offline so the runtime needs no per-call
inverse-perm gather. Additional transforms: --pack / --unpack convert
between the v1 bit-packed stream and the separate-plane index formats.
The tensors are processed on ``--device`` (the card by default).

Usage:
    python -m vptq_tpu_torch.tools.pre_process -m IN_DIR -o OUT_DIR \
        [--absorb-perm] [--pack | --unpack] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import logging
import sys

from vptq_tpu_torch.models.loader import entry_device
from vptq_tpu_torch.tools.checkpoint_tools import (
    absorb_perm,
    load_raw_state,
    pack_checkpoint,
    save_state,
    unpack_checkpoint,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--model", required=True, help="input dir")
    p.add_argument("-o", "--output", required=True, help="output dir")
    p.add_argument(
        "--absorb-perm", action="store_true", default=True,
        help="fold input permutations into index order (default on)",
    )
    p.add_argument(
        "--no-absorb-perm", dest="absorb_perm", action="store_false"
    )
    p.add_argument("--pack", action="store_true",
                   help="pack separate index planes into int32 stream")
    p.add_argument("--unpack", action="store_true",
                   help="unpack int32 stream into separate planes")
    p.add_argument("--device", default="cuda",
                   help="where the tensors are processed (default cuda)")
    args = p.parse_args(argv)

    if args.pack and args.unpack:
        print("--pack and --unpack are exclusive", file=sys.stderr)
        return 2
    device = entry_device(args.device)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    )

    state, config = load_raw_state(args.model, device)
    if args.absorb_perm:
        state, config = absorb_perm(state, config)
    if args.pack:
        state, config = pack_checkpoint(state, config)
    if args.unpack:
        state, config = unpack_checkpoint(state, config)
    out = save_state(state, config, args.output)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
