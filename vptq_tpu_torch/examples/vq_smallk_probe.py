"""The small-codebook VQ probe P3 on the card: can a codebook of at most
256 vectors be expanded inside a GEMV at serving speed?

Port of ``examples/vq_smallk_probe.py``. Format under test: ids (out,
in/v) uint8, each selecting a v-vector (v = 4 or 8) of a (256, v)
codebook laid along in_features: 8/v bits per weight plus the codebook.
The kernel (``vq_smallk_matmul``) stages the codebook in shared memory and
reads one vector per id; the onehot-only rows stream the ids and add x
where an id is in the codebook, the floor of the same kernel.

Prints one line per (v, variant) at the 22016 x 4096 gate_up shape of a
7B model, decode (T = 1): µs, G ids/s, weights/s and the 7B decode tok/s
those linears alone would allow at 6.61e9 weights per token; then the
card's own K2 / K3 / K4 rates at the same shape, measured in the same
run. Every number is a time on the card named in the first line.

    python -m vptq_tpu_torch.examples.vq_smallk_probe [--check]
        [--device cuda]

``--check``: 256 x 1024, v 8, k 256, T 3 in f32 against the numpy
product, within the script's limit.
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
from vptq_tpu_torch.ops.vq_smallk_matmul import vq_smallk_matmul
from vptq_tpu_torch.ops.w2_matmul import w2_matmul
from vptq_tpu_torch.ops.w3_matmul import w3_matmul
from vptq_tpu_torch.ops.w4_matmul import w4_matmul

__all__ = ["SHAPE", "WEIGHTS_PER_TOKEN", "check", "check_case", "main",
           "vq_matmul"]

SHAPE = (22016, 4096)  # 7B gate_up, decode
# 7B decode reads 6.61e9 linear weights per token (Llama-2-7B geometry,
# the embedding left out)
WEIGHTS_PER_TOKEN = 6.61e9


def vq_matmul(x, ids, codebook, *, v, onehot_only=False):
    """Fused VQ dequant-matmul: x @ (C[ids] reshaped (out, in))^T; an id
    >= k adds 0. The TPU kernel's tiles are no part of the function."""
    return vq_smallk_matmul(x, ids, codebook, v, onehot_only)


def check_case(k=256):
    """The script's --check case: 256 x 1024, v 8, T 3, ids drawn from
    [0, 256) (so for k below 256 some lie past the codebook), a
    (k, 8) f32 codebook and f32 x; numpy arrays (x, ids, codebook,
    weight) from seed 0, ``weight`` the (out, in) f32 weight the ids pick
    (zeros for an id >= k)."""
    rng = np.random.default_rng(0)
    v = 8
    of, inf_ = 256, 1024
    ids = rng.integers(0, 256, (of, inf_ // v)).astype(np.uint8)
    cb = rng.normal(0, 0.02, (k, v)).astype(np.float32)
    x = rng.normal(0, 1, (3, inf_)).astype(np.float32)
    padded = np.zeros((256, v), np.float32)
    padded[:k] = cb
    return x, ids, cb, padded[ids.reshape(-1)].reshape(of, inf_)


def check(device="cuda"):
    """The script's --check on the card against the numpy product; prints
    and returns (max |err|, the script's limit 0.05·max|want| + 0.05)."""
    device = torch.device(device)
    x, ids, cb, w = check_case()
    want = x @ w.T
    got = vq_matmul(
        torch.from_numpy(x).to(device), torch.from_numpy(ids).to(device),
        torch.from_numpy(cb).to(device), v=8,
    ).cpu().numpy()
    err = float(np.abs(got - want).max())
    limit = float(0.05 * np.abs(want).max() + 0.05)
    print("check max abs err:", err, flush=True)
    return err, limit


def _rate(out_f, in_f, t):
    return out_f * in_f / t / 1e12


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = pick_device(args.device)
    print(f"# {card_line(device)}", flush=True)
    if args.check:
        err, limit = check(device)
        if not err < limit:
            raise AssertionError(f"max abs err {err} over the limit {limit}")
        return

    out_f, in_f = SHAPE
    rng = np.random.default_rng(0)
    timeit = make_timer(50)
    print(f"# shape {out_f}x{in_f} (7B gate_up), decode T=1", flush=True)
    for v in (4, 8):
        for onehot_only in (False, True):
            ids = torch.from_numpy(
                rng.integers(0, 256, (out_f, in_f // v)).astype(np.uint8)
            ).to(device)
            cb = torch.from_numpy(
                rng.normal(0, 0.02, (256, v)).astype(np.float32)
            ).to(device, torch.bfloat16)
            x = torch.from_numpy(
                rng.normal(0, 1, (1, in_f)).astype(np.float32)
            ).to(device, torch.bfloat16)
            t = timeit(
                lambda xi, i=ids, c=cb, vv=v, oh=onehot_only: vq_matmul(
                    xi, i, c, v=vv, onehot_only=oh), x)
            n_ids = out_f * in_f // v
            tok_s = _rate(out_f, in_f, t) * 1e12 / WEIGHTS_PER_TOKEN
            tag = "onehot-only" if onehot_only else "fused"
            print(f"v={v} k=256 {tag:12s}: {t*1e6:8.1f} us  "
                  f"{n_ids/t/1e9:6.2f} G ids/s  "
                  f"{_rate(out_f, in_f, t):5.3f} Tw/s  -> 7B {tok_s:6.1f} "
                  f"tok/s  ({8/v:.1f} bits/w)", flush=True)

    # the card's scalar-plane kernels on random codes of the same shape
    x = torch.ones((1, in_f), dtype=torch.bfloat16, device=device)

    def codes(n):
        return torch.from_numpy(
            rng.integers(-128, 128, (out_f, n)).astype(np.int8)).to(device)

    def scales(*shape):
        return torch.from_numpy(
            (0.005 * (1 + rng.random(shape))).astype(np.float32)
        ).to(device, torch.bfloat16)

    w4 = (codes(in_f // 2), scales(in_f // 128, out_f))
    w2 = (codes(in_f // 4), scales(out_f, in_f // 64))
    w3 = (codes(in_f // 4), codes(in_f // 8), scales(out_f, in_f // 128))
    rates = {
        name: _rate(out_f, in_f, timeit(lambda xi, f=fn, a=a: f(xi, *a), x))
        for name, fn, a in (("w4", w4_matmul, w4), ("w2", w2_matmul, w2),
                            ("w3", w3_matmul, w3))
    }
    print("# scalar-plane kernels, same shape, this run (K2 w4_matmul, "
          "K3 w2_matmul group 64, K4 w3_matmul): "
          + ", ".join(f"{k} {r:.3f} Tw/s" for k, r in rates.items()))


if __name__ == "__main__":
    main()
