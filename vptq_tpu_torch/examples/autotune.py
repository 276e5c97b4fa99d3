"""Launch-plan sweep of K1–K4 at decode (T = 1), shared by the four
``autotune_w{8,4,3,2}`` entry points.

The port of ``examples/autotune_w{8,4,3,2}.py``, which swept the TPU
kernels' ``(out_tile, in_tile)`` at a 7B model's linears. The CUDA
kernels' counterpart of a tile size is the launch plan that
``ops/scaled_matmul.py`` passes them: the decode GEMV's cluster split (1,
2, 4 or 8 blocks over a row's stages, those whose shared memory fits a
block) and split 0, which routes the call to the older GEMV (``w8.cuh``'s
``w8_gemv``, ``lowbit.cuh``'s ``gemv``). Each shape is swept at every
plan it admits (:func:`plans`), each launch first held to the plain
version (|err| <= 1e-2·|plain| + 1e-3·max|plain|, ``decode_splits``'
bound), then timed: the median of ``--iters`` launches between CUDA
events, each after a 1 GiB read that leaves a clean L2, as a decode step
finds it. Last, the kernel's own wrapper at the same inputs: the route
the main path takes (its split: ``decode_split``'s, or 0 where the
wrapper sends one token to the older GEMV), held and timed alike.

The card's name and power limit come first; then one line per (shape,
plan) with µs, weight GB/s (codes and scales read once) and the bound
(those bytes at the card's 3.35 TB/s), the fastest starred, and the
JAX scripts' ``# name: best ... @ ... GB/s`` line per shape beside the
route's plan. ``--device cpu`` prints the plans each shape admits on an
H100 (132 SMs) and runs nothing.
"""

from __future__ import annotations

import argparse
import statistics

import torch

from vptq_tpu_torch.examples.kernel_bench import card_line, flush_buffer
from vptq_tpu_torch.models.loader import entry_device
from vptq_tpu_torch.ops import scaled_matmul as sm
from vptq_tpu_torch.ops.w2_matmul import w2_matmul, w2_matmul_reference
from vptq_tpu_torch.ops.w3_matmul import (
    takes_decode_gemv as w3_takes_decode_gemv,
)
from vptq_tpu_torch.ops.w3_matmul import w3_matmul, w3_matmul_reference
from vptq_tpu_torch.ops.w4_matmul import w4_matmul, w4_matmul_reference
from vptq_tpu_torch.ops.w8_matmul import (
    takes_decode_gemv,
    w8_matmul,
    w8_matmul_reference,
)
from vptq_tpu_torch.utils.profiling import H100_HBM_GBPS

__all__ = ["SWEEPS", "plans", "route_split", "main", "sweep"]

# the JAX scripts' shapes: (name, out, in, scale group); K1's groups as
# autotune_w8.py gives them, K2 and K4 at their fixed 128, K3 at 64 and
# 128
SWEEPS = {
    "w8": (("qkv", 12288, 4096, 2048), ("gate_up", 22016, 4096, 2048),
           ("down", 4096, 11264, 1024), ("lm_head", 32000, 4096, 2048),
           ("o", 4096, 4096, 2048)),
    "w4": (("qkv", 12288, 4096, 128), ("gate_up", 22016, 4096, 128),
           ("down", 4096, 12288, 128), ("o", 4096, 4096, 128)),
    "w3": (("qkv", 12288, 4096, 128), ("gate_up", 22016, 4096, 128),
           ("down", 4096, 12288, 128), ("o", 4096, 4096, 128)),
    "w2": (("down", 4096, 11264, 64), ("down", 4096, 11264, 128)),
}
H100_SMS = 132
TOKENS = 1


def _fmt(kernel: str, group: int) -> str:
    """The key of ``sm.DECODE_FORMATS``."""
    return f"w2g{group}" if kernel == "w2" else kernel


def _positions(kernel: str, in_f: int) -> int:
    """Stage positions a row of ``in_f`` columns spans (the bytes of one
    plane: int8 in, int4 in / 2, int2 in / 4, int3 in / 8)."""
    return in_f // {"w8": 1, "w4": 2, "w2": 4, "w3": 8}[kernel]


def plans(kernel: str, out_f: int, in_f: int, group: int,
          n_sm: int = H100_SMS, tokens: int = TOKENS) -> list:
    """The plans a shape admits at ``tokens``: 0 (the older GEMV), then
    each split of ``sm.DECODE_SPLITS`` no larger than the row's stages
    whose block fits its shared memory, as ``decode_split`` counts them."""
    parts, planes, scale_bytes = sm.DECODE_FORMATS[_fmt(kernel, group)]
    positions = _positions(kernel, in_f)
    stages = positions // sm.DECODE_STAGE
    if positions % sm.DECODE_STAGE or (kernel == "w8"
                                       and group % sm.DECODE_STAGE):
        return [0]
    return [0] + [
        s for s in sm.DECODE_SPLITS
        if s <= stages and sm.decode_smem(
            parts, tokens, -(-stages // s), planes, scale_bytes)
        <= sm._BLOCK_SMEM
    ]


def route_split(kernel: str, out_f: int, in_f: int, group: int,
                n_sm: int = H100_SMS, tokens: int = TOKENS) -> int:
    """The split the kernel's wrapper passes at ``tokens``: decode_split's
    plan, or 0 where it sends the call to the older GEMV (K1 at 1–2
    tokens, K4 at 1–2 tokens on a weight of at most 2^24 entries)."""
    if kernel == "w8" and not takes_decode_gemv(tokens, out_f, in_f):
        return 0
    if kernel == "w3" and not w3_takes_decode_gemv(tokens, out_f, in_f):
        return 0
    if kernel == "w8" and group % sm.DECODE_STAGE:
        return 0
    parts, planes, scale_bytes = sm.DECODE_FORMATS[_fmt(kernel, group)]
    return sm.decode_split(out_f, _positions(kernel, in_f), parts, tokens,
                           n_sm, planes, scale_bytes)


def _case(kernel: str, out_f: int, in_f: int, group: int, gen, device):
    """(library, weights, ints before the split, wrapper, plain version)
    on random codes and scales."""
    def codes(n):
        return torch.randint(-128, 128, (out_f, n), generator=gen,
                             device=device, dtype=torch.int8)

    def scales(*shape):
        return (torch.rand(shape, generator=gen, device=device)
                * 1e-2).to(torch.bfloat16)

    if kernel == "w8":
        sc = torch.rand((in_f // group, out_f), generator=gen,
                        device=device) * 1e-2
        return ("w8_matmul", (codes(in_f), sc), (group,), w8_matmul,
                w8_matmul_reference)
    if kernel == "w4":
        return ("w4_matmul", (codes(in_f // 2), scales(in_f // 128, out_f)),
                (), w4_matmul, w4_matmul_reference)
    if kernel == "w3":
        return ("w3_matmul", (codes(in_f // 4), codes(in_f // 8),
                              scales(out_f, in_f // 128)),
                (), w3_matmul, w3_matmul_reference)
    return ("w2_matmul", (codes(in_f // 4), scales(out_f, in_f // group)),
            (group,), w2_matmul, w2_matmul_reference)


def _time(fn, flush, iters: int) -> float:
    """Median µs of ``iters`` calls, each after a 1 GiB read (a clean
    L2)."""
    sink = torch.zeros((), dtype=torch.int64, device=flush.device)
    words = flush.view(torch.int32)
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        sink.copy_(words.sum())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times) * 1e3


def sweep(kernel: str, device, iters: int = 30, seed: int = 0) -> list:
    """Sweep ``kernel``'s shapes on ``device``; returns one record per
    shape: its best plan, the route's plan and every plan's µs."""
    device = torch.device(device)
    records = []
    if device.type != "cuda":
        for name, out_f, in_f, group in SWEEPS[kernel]:
            admitted = plans(kernel, out_f, in_f, group)
            route = route_split(kernel, out_f, in_f, group)
            print(f"{name:8s} {out_f}x{in_f} g={group}: plans "
                  f"{admitted}, route split={route} (an H100's "
                  f"{H100_SMS} SMs; nothing run on the CPU)", flush=True)
            records.append(dict(kernel=kernel, shape=name, out=out_f,
                                in_=in_f, group=group, plans=admitted,
                                route=route))
        return records
    n_sm = sm.sm_count(device)
    flush = flush_buffer(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, out_f, in_f, group in SWEEPS[kernel]:
        lib, weights, ints, wrapper, ref = _case(kernel, out_f, in_f, group,
                                                 gen, device)
        nbytes = sum(t.numel() * t.element_size() for t in weights)
        bound_us = nbytes / (H100_HBM_GBPS * 1e9) * 1e6
        x = torch.randn((TOKENS, in_f), generator=gen, device=device).to(
            torch.bfloat16)
        want = ref(x, *weights).float()
        limit = 1e-2 * want.abs() + 1e-3 * want.abs().max()
        calls = {}
        for split in plans(kernel, out_f, in_f, group, n_sm):
            calls[f"split={split}"] = (
                lambda split=split: sm.launch(
                    lib, f"vptq_{lib}", x, weights, (*ints, split), out_f,
                    in_f, None))
        route = route_split(kernel, out_f, in_f, group, n_sm)
        routed = f"route (split={route})"
        calls[routed] = lambda: wrapper(x, *weights)
        times = {}
        for plan, call in calls.items():
            if not bool(torch.all((call().float() - want).abs() <= limit)):
                raise AssertionError(f"{kernel} {name} {plan}: outside the "
                                     "tolerance of the plain version")
            times[plan] = _time(call, flush, iters)
        best = min((p for p in times if p.startswith("split=")),
                   key=times.__getitem__)
        for plan, us in times.items():
            mark = " *" if plan == best else ""
            print(f"{kernel} {name:8s} g={group:<5d} {plan:16s} {us:8.1f} us "
                  f"{nbytes / us / 1e3:7.1f} GB/s  bound {bound_us:6.1f} us"
                  f"{mark}", flush=True)
        print(f"# {kernel} {name}: best {best} @ "
              f"{nbytes / times[best] / 1e3:.0f} "
              f"GB/s ({routed}: {nbytes / times[routed] / 1e3:.0f} GB/s)",
              flush=True)
        records.append(dict(kernel=kernel, shape=name, out=out_f, in_=in_f,
                            group=group, plans=list(times), route=route,
                            best=int(best[len("split="):]), us=times,
                            bound_us=bound_us))
        del weights
    return records


def main(argv, kernel: str) -> list:
    """The sweep of ``kernel`` (a key of :data:`SWEEPS`) as an entry point
    (``autotune_w8`` etc.)."""
    parser = argparse.ArgumentParser(
        description=f"Launch-plan sweep of {kernel} at decode")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iters", type=int, default=30)
    args = parser.parse_args(argv)
    device = entry_device(args.device)
    print(card_line(device), flush=True)
    return sweep(kernel, device, args.iters)
