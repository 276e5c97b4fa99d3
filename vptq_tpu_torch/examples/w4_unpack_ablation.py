"""The int4 unpack ablation P2 on the card: K2's function, one knob moved
at a time.

Port of ``examples/w4_unpack_ablation.py``. Modes of the op
``w4_probe_matmul`` at decode (T = 1):

  prod      K2's function with the TPU kernel's unpack (sign-extended low
            nibble)
  shift28   low level ``w << 28``, 2⁻²⁸ folded into the low half's scales
  t8        prod with x read in f32 (the TPU script's 8-row token tile
            needs f32 operands; on the card only the operand type is left)
  g256      prod with one scale row per 256 columns (a group-256 format)

The TPU script's ``it4096`` rows time another tile of the same function;
the card's kernels pick their own tiles, so they have no counterpart.
Every line is a time on the card named in the first line.

    python -m vptq_tpu_torch.examples.w4_unpack_ablation [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from vptq_tpu_torch.examples.kernel_bench import (
    card_line,
    make_timer,
    pick_device,
)
from vptq_tpu_torch.examples.w4_wall_candidates import SHAPES
from vptq_tpu_torch.ops.packing import pack_int4
from vptq_tpu_torch.ops.w4_probe_matmul import w4_probe_matmul

__all__ = ["MODES", "check_shift28", "main", "shift28_case",
           "variant_matmul"]

W4_GROUP = 128
MODES = ("prod", "shift28", "t8", "g256")


def variant_matmul(x, wq, scales, *, mode):
    """x (T, in) float; wq (out, in/2) int8; scales (in/128, out), cast to
    bf16 as the script does; t8 reads x in f32. Returns x's dtype."""
    xdt = torch.float32 if mode == "t8" else torch.bfloat16
    return w4_probe_matmul(
        x.to(xdt), wq, scales.to(torch.bfloat16), mode, out_dtype=x.dtype)


def shift28_case():
    """The script's shift28 check: levels q (2048, 2048) in [−8, 8),
    scales (16, 2048) and x (3, 2048) in f32, and the f32 weight (in, out)
    they make; numpy arrays (x, q, scales, weight) from seed 0."""
    rng = np.random.default_rng(0)
    out_f, in_f = 2048, 2048
    q = rng.integers(-8, 8, (out_f, in_f)).astype(np.int8)
    s = (0.01 * (1 + rng.random((in_f // 128, out_f)))).astype(np.float32)
    xs = rng.standard_normal((3, in_f)).astype(np.float32)
    w_ref = (
        q.astype(np.float32).T.reshape(in_f // 128, 128, out_f)
        * s[:, None, :]
    ).reshape(in_f, out_f)
    return xs, q, s, w_ref


def check_shift28(device="cuda") -> float:
    """The exactness of the 2⁻²⁸ fold on :func:`shift28_case`, packed by
    ``pack_int4``, with bf16 x and scales; prints and returns max |err| /
    max |want|."""
    device = torch.device(device)
    xs, q, s, w_ref = shift28_case()
    want = xs @ w_ref
    got = variant_matmul(
        torch.from_numpy(xs).to(device, torch.bfloat16),
        pack_int4(torch.from_numpy(q)).to(device),
        torch.from_numpy(s).to(device), mode="shift28",
    ).float().cpu().numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"shift28 correctness: max rel err {rel:.4f}", flush=True)
    return rel


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = pick_device(args.device)
    print(f"# {card_line(device)}", flush=True)
    timeit = make_timer(300)
    rng = np.random.default_rng(0)
    check_shift28(device)

    for name, out_f, in_f in SHAPES:
        in_p = in_f
        wq = torch.from_numpy(
            rng.integers(-128, 128, (out_f, in_p // 2)).astype(np.int8)
        ).to(device)
        n_groups = in_p // W4_GROUP
        scales = torch.from_numpy(
            (0.005 * (1 + rng.random((n_groups, out_f)))).astype(np.float32)
        ).to(device, torch.bfloat16)
        x = torch.ones((1, in_p), dtype=torch.bfloat16, device=device)
        nbytes = wq.numel() + n_groups * out_f * 2
        for mode in MODES:
            # x in the mode's type, made once outside the timed call
            xm = x.float() if mode == "t8" else x
            t = timeit(
                lambda v, m=mode: w4_probe_matmul(
                    v, wq, scales, m, out_dtype=torch.bfloat16), xm)
            print(f"{name:8s} {mode:8s} {t*1e6:8.1f} us "
                  f"{nbytes/t/1e9:7.1f} GB/s {out_f*in_p/t/1e12:6.3f} Tw/s",
                  flush=True)
        del wq, scales


if __name__ == "__main__":
    main()
