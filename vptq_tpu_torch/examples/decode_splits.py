"""K1–K4's and K5b's decode GEMV at every cluster size, beside the older GEMV.

Times K1 ``w8_matmul`` (group 2048), K2 ``w4_matmul``, K4 ``w3_matmul``
and K3 ``w2_matmul`` (groups 64 and 128) on random codes at the four
linears of a Llama-3.1-8B layer, for each token count, and K5b
``w4_matmul_pairs`` (``w4p``) at a Mixtral-8x7B layer's two expert shapes
on a stack of 8 random experts, for each pair count (the first P of
seeded top-2 picks of ⌈P / 2⌉ tokens), through the launch
of ``ops/scaled_matmul.py`` with each split the kernel takes (1, 2, 4, 8;
the one ``decode_split`` plans is starred) and with split 0, which routes
the call to the GEMV the decode kernel replaced (``w8.cuh``'s
``w8_gemv``, ``lowbit.cuh``'s ``gemv``). Every launch is first held to the
plain version (|err| <= 1e-2·|plain| + 1e-3·max|plain|). Each time is the
median of 30 launches between CUDA events, each after a 1 GiB flush of the
L2: ``w`` overwrites the buffer (the L2 is left full of dirty lines that
the timed call writes back, as ``kernel_bench.time_ms`` leaves it), ``r``
only reads it (a clean L2, as a decode step finds it). The card's name and
power limit come first, then one line per (kernel, shape, T, split,
flush; K5b: P for T), then the layer's sums for the planned split and
split 0.

    python -m vptq_tpu_torch.examples.decode_splits [--tokens 1,4,16]
        [--pairs 1,2,16] [--flush w,r] [--kernels w8,w4,w3,w2g64,w2g128,w4p]

Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import statistics

import torch

from vptq_tpu_torch.examples.kernel_bench import card_line, flush_buffer
from vptq_tpu_torch.ops import scaled_matmul as sm
from vptq_tpu_torch.ops.w2_matmul import w2_matmul_reference
from vptq_tpu_torch.ops.w3_matmul import w3_matmul_reference
from vptq_tpu_torch.ops.w4_matmul import w4_matmul_reference
from vptq_tpu_torch.ops.w4_matmul_pairs import w4_matmul_pairs_reference
from vptq_tpu_torch.ops.w8_matmul import w8_matmul_reference

__all__ = ["main"]

# (name, out, in) of one Llama-3.1-8B layer's linears
SHAPES = (("qkv", 6144, 4096), ("o", 4096, 4096), ("gate_up", 28672, 4096),
          ("down", 4096, 14336))
# (name, out, in) of one Mixtral-8x7B layer's two stacked expert weights
MOE_SHAPES = (("gate_up", 28672, 4096), ("down", 4096, 14336))
EXPERTS, TOP_K = 8, 2
GROUP = 2048  # K1's scale group at these widths (the loaders' pick)
KERNELS = ("w8", "w4", "w3", "w2g64", "w2g128", "w4p")


def _time(fn, flush, mode: str, iters: int = 30) -> float:
    """Median ms of ``iters`` calls, each after a 1 GiB flush."""
    sink = torch.zeros((), dtype=torch.int64, device=flush.device)
    words = flush.view(torch.int32)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if mode == "w":
            flush.zero_()
        else:
            sink.copy_(words.sum())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _case(kernel: str, out_f: int, in_p: int, gen, device):
    """(library, weights, ints before the split, positions, plain version)
    of one kernel on random codes and scales (K5b: a stack of EXPERTS)."""
    def codes(n):
        lead = (EXPERTS,) if kernel == "w4p" else ()
        return torch.randint(-128, 128, (*lead, out_f, n), generator=gen,
                             device=device, dtype=torch.int8)

    def scales(*shape):
        lead = (EXPERTS,) if kernel == "w4p" else ()
        return (torch.rand((*lead, *shape), generator=gen, device=device)
                * 1e-2).to(torch.bfloat16)

    if kernel == "w4p":
        return ("w4_matmul_pairs",
                (codes(in_p // 2), scales(in_p // 128, out_f)),
                (EXPERTS,), in_p // 2, w4_matmul_pairs_reference)
    if kernel == "w8":
        sc = torch.rand((in_p // GROUP, out_f), generator=gen,
                        device=device) * 1e-2
        return ("w8_matmul", (codes(in_p), sc), (GROUP,), in_p,
                w8_matmul_reference)
    if kernel == "w4":
        return ("w4_matmul", (codes(in_p // 2), scales(in_p // 128, out_f)),
                (), in_p // 2, w4_matmul_reference)
    if kernel == "w3":
        return ("w3_matmul", (codes(in_p // 4), codes(in_p // 8),
                              scales(out_f, in_p // 128)),
                (), in_p // 8, w3_matmul_reference)
    group = int(kernel[len("w2g"):])
    return ("w2_matmul", (codes(in_p // 4), scales(out_f, in_p // group)),
            (group,), in_p // 4, w2_matmul_reference)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tokens", default="1,4,16")
    parser.add_argument("--pairs", default="1,2,16")
    parser.add_argument("--flush", default="w,r")
    parser.add_argument("--kernels", default=",".join(KERNELS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_splits times the card's kernels: it needs a "
                         "CUDA device")
    device = torch.device("cuda")
    print(card_line(device), flush=True)
    tokens = [int(t) for t in args.tokens.split(",")]
    pairs = [int(p) for p in args.pairs.split(",")]
    modes = args.flush.split(",")
    flush = flush_buffer(device)
    gen = torch.Generator(device=device).manual_seed(0)
    cpu_gen = torch.Generator().manual_seed(0)
    n_sm = sm.sm_count(device)
    layer = {}
    for kernel in args.kernels.split(","):
        moe = kernel == "w4p"
        unit = "P" if moe else "T"
        parts, planes, scale_bytes = sm.DECODE_FORMATS[
            "w4" if moe else kernel]
        for shape, out_f, in_p in MOE_SHAPES if moe else SHAPES:
            lib, weights, ints, positions, ref = _case(
                kernel, out_f, in_p, gen, device)
            stages = positions // sm.DECODE_STAGE
            for n in pairs if moe else tokens:
                # a pair is one token through its expert
                t, n_pairs = (1, n) if moe else (n, 1)
                x = torch.randn((n, in_p), generator=gen, device=device).to(
                    torch.bfloat16)
                extra = {}
                if moe:
                    extra["ids"] = torch.cat([
                        torch.randperm(EXPERTS, generator=cpu_gen)[:TOP_K]
                        for _ in range(-(-n // TOP_K))
                    ])[:n].to(device=device, dtype=torch.int32)
                plan = sm.decode_split(out_f, positions, parts, t, n_sm,
                                       planes, scale_bytes, n_pairs)
                want = ref(x, *weights, *extra.values()).float()
                limit = 1e-2 * want.abs() + 1e-3 * want.abs().max()
                for split in (0, *sm.DECODE_SPLITS):
                    if split > stages or (split and sm.decode_smem(
                            parts, t, -(-stages // split), planes,
                            scale_bytes) > 232448):
                        continue

                    def call(split=split):
                        return sm.launch(lib, f"vptq_{lib}", x, weights,
                                         (*ints, split), out_f, in_p, None,
                                         **extra)

                    if not bool(torch.all((call().float() - want).abs()
                                          <= limit)):
                        raise AssertionError(
                            f"{kernel} {shape} {unit}={n} split={split}: "
                            "outside the tolerance")
                    for mode in modes:
                        us = _time(call, flush, mode) * 1e3
                        star = "*" if split == plan else ""
                        print(f"{kernel} {shape} {unit}={n} split={split}"
                              f"{star} flush={mode}: {us:.1f} us", flush=True)
                        if split in (0, plan):
                            key = (kernel, unit, n, mode, split == 0)
                            layer[key] = layer.get(key, 0.0) + us
            del weights
    for (kernel, unit, n, mode, old), us in sorted(layer.items()):
        what = "old GEMV (split 0)" if old else "decode GEMV (planned split)"
        print(f"layer {kernel} {unit}={n} flush={mode} {what}: {us:.1f} us",
              flush=True)
    print(card_line(device), flush=True)


if __name__ == "__main__":
    main()
