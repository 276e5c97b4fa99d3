"""The int4 unpack candidates P1 on the card: is the int4 GEMV bound by its
bytes, or by the instructions that unpack a nibble?

Port of ``examples/w4_wall_candidates.py``. Each mode is K2's GEMV at
decode (T = 1) with another unpack, through the port's hand-written
kernels:

  prod      low level ``w << 28`` with 2⁻²⁸ folded into the low half's
            scales, high level ``w >> 4`` (the op ``w4_probe_matmul``'s
            ``shift28``)
  fma16     byte = 16·hi + lo: one convert, ``hi = rint(b / 16)``,
            ``lo = b − 16·hi``
  fma16f32  fma16 with x read in f32
  i32x8     eight offset-unsigned nibble planes per int32 word
            (``w4_i32x8_matmul``)
  s8dot     probe, wrong on purpose: int8 x times the raw bytes, exact
            int32 sums (``__dp4a``; ``w4_raw_probe``)
  cvtonly   probe, wrong on purpose: one convert per raw byte, no bit logic

and, to read them against, one row each for the port's K2 ``w4_matmul``
(the production kernel) and ``torch.matmul`` on the dequantized bf16
weight. Every line is a time on the card named in the first line.

    python -m vptq_tpu_torch.examples.w4_wall_candidates [--device cuda]
        [--modes prod,fma16]
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
from vptq_tpu_torch.ops.packing import unpack_int4
from vptq_tpu_torch.ops.w4_i32x8_matmul import w4_i32x8_matmul
from vptq_tpu_torch.ops.w4_matmul import w4_matmul
from vptq_tpu_torch.ops.w4_probe_matmul import w4_probe_matmul
from vptq_tpu_torch.ops.w4_raw_probe import w4_raw_probe

__all__ = ["MODES", "SHAPES", "check_fma16_exact", "fma16_case", "main",
           "run_variant"]

GROUP = 128
MODES = ("prod", "fma16", "fma16f32", "i32x8", "s8dot", "cvtonly")
# the decode shapes of one Llama-2-7B layer: (name, out, in); every in is
# a multiple of 4096, so the scripts' padding to 4096 leaves them as they are
SHAPES = (
    ("gate_up", 22016, 4096),
    ("down", 4096, 12288),
    ("qkv", 12288, 4096),
    ("o", 4096, 4096),
)


def run_variant(mode, x, wq, scales):
    """x (T, in) float (rounded to bf16); wq packed (out, in/2) int8 (the
    prod / fma16 nibble layouts, the raw probes) or (out, in/8) int32
    (i32x8); scales (in/128, out) bf16. The TPU kernel's tiles are no part
    of the function: the card's kernels pick their own."""
    if mode == "i32x8":
        return w4_i32x8_matmul(x, wq, scales)
    if mode in ("s8dot", "cvtonly"):
        # the packed bytes against columns [0, in/2) of x, as the script
        # slices and casts them outside its kernel
        xh = x[..., : x.shape[-1] // 2].to(torch.bfloat16)
        if mode == "s8dot":
            xh = xh.to(torch.int8)
        return w4_raw_probe(xh, wq, scales, mode, out_dtype=x.dtype)
    if mode not in MODES:
        raise ValueError(mode)
    return w4_probe_matmul(x, wq, scales, "shift28" if mode == "prod" else mode)


def fma16_case():
    """The script's fma16 check: q (512, 2048) int4 pairs in [−7, 7]
    encoded as byte = 16·q_hi + q_lo over the half-split layout of prod,
    scales (16, 512) and x (3, 2048) in f32, and the f32 weight (in, out)
    they encode; numpy arrays (x, bytes, scales, weight) from seed 0."""
    rng = np.random.default_rng(0)
    out_f, in_f = 512, 2048
    q = rng.integers(-7, 8, (out_f, in_f)).astype(np.int32)
    half = in_f // 2
    b = (16 * q[:, half:] + q[:, :half]).astype(np.int8)
    s = (0.01 * (1 + rng.random((in_f // 128, out_f)))).astype(np.float32)
    xs = rng.standard_normal((3, in_f)).astype(np.float32)
    w_ref = (
        q.astype(np.float32).T.reshape(in_f // 128, 128, out_f)
        * s[:, None, :]
    ).reshape(in_f, out_f)
    return xs, b, s, w_ref


def check_fma16_exact(device="cuda") -> float:
    """fma16 on :func:`fma16_case` with bf16 x and bf16 scales; prints and
    returns max |err| / max |want|."""
    device = torch.device(device)
    xs, b, s, w_ref = fma16_case()
    want = xs @ w_ref
    got = run_variant(
        "fma16", torch.from_numpy(xs).to(device, torch.bfloat16),
        torch.from_numpy(b).to(device),
        torch.from_numpy(s).to(device, torch.bfloat16),
    ).float().cpu().numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"fma16 correctness (bf16 x + bf16 scales): rel err {rel:.4f}",
          flush=True)
    return rel


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--modes", default=",".join(MODES),
                        help="comma-separated subset of " + ",".join(MODES))
    args = parser.parse_args(argv)
    device = pick_device(args.device)
    modes = args.modes.split(",")
    print(f"# {card_line(device)}", flush=True)
    timeit = make_timer(300)
    rng = np.random.default_rng(0)
    check_fma16_exact(device)

    for name, out_f, in_f in SHAPES:
        in_p = in_f
        n_groups = in_p // GROUP
        wq8 = torch.from_numpy(
            rng.integers(-120, 120, (out_f, in_p // 2)).astype(np.int8)
        ).to(device)
        wq32 = torch.from_numpy(
            rng.integers(-(2 ** 31), 2 ** 31 - 1, (out_f, in_p // 8),
                         dtype=np.int64).astype(np.int32)
        ).to(device)
        scales = torch.from_numpy(
            (0.005 * (1 + rng.random((n_groups, out_f)))).astype(np.float32)
        ).to(device, torch.bfloat16)
        x = torch.ones((1, in_p), dtype=torch.bfloat16, device=device)
        nbytes = out_f * in_p // 2 + n_groups * out_f * 2

        def row(label, t, b=nbytes):
            print(f"{name:8s} {label:9s} {t*1e6:8.1f} us {b/t/1e9:7.1f} GB/s "
                  f"{out_f*in_p/t/1e12:6.3f} Tw/s", flush=True)

        # x as each kernel reads it, made once outside the timed call (the
        # script casts inside its jit)
        xs = {"fma16f32": x.float(), "s8dot": x[:, : in_p // 2].to(torch.int8),
              "cvtonly": x[:, : in_p // 2].contiguous()}

        def call(v, mode):
            if mode in ("s8dot", "cvtonly"):
                return w4_raw_probe(v, wq8, scales, mode,
                                    out_dtype=torch.bfloat16)
            if mode == "i32x8":
                return w4_i32x8_matmul(v, wq32, scales)
            return w4_probe_matmul(v, wq8, scales,
                                   "shift28" if mode == "prod" else mode,
                                   out_dtype=torch.bfloat16)

        for mode in modes:
            row(mode, timeit(lambda v, m=mode: call(v, m), xs.get(mode, x)))
        row("w4_matmul", timeit(lambda v: w4_matmul(v, wq8, scales), x))
        w = (unpack_int4(wq8).float()
             * scales.float().t().repeat_interleave(GROUP, dim=1)
             ).to(torch.bfloat16)
        row("matmul", timeit(lambda v: torch.matmul(v, w.t()), x),
            b=w.numel() * 2)
        del wq8, wq32, scales, w


if __name__ == "__main__":
    main()
