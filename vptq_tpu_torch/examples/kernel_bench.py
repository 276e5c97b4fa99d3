"""K1 ``w8_matmul`` per 7B linear shape at decode (T = 1) on the card.

Port of ``examples/kernel_bench.py``: the four linears of one Llama-2-7B
decoder layer and an int8 lm_head, each an ``Int8Linear`` of random codes
and scales made on the device, and the bf16 lm_head through
``DenseLinear``; one line per shape with µs, MB and GB/s, then the 32
layers' sum. Also the timer the other examples and ``chip_smoke.py``
share: CUDA events around each call, each after a 1 GiB overwrite that
evicts the L2.

    python -m vptq_tpu_torch.examples.kernel_bench [n_iter] [--device cuda]
"""

from __future__ import annotations

import argparse
import gc
import statistics
import subprocess
import sys
import time

import torch

__all__ = ["card_line", "flush_buffer", "make_timer", "pick_device", "time_ms"]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def flush_buffer(device):
    """1 GiB overwritten before each timed launch evicts the 50 MB L2, and
    keeps the card busy (~0.3 ms) while the host enqueues the timed call,
    so host overhead does not open a gap inside the events."""
    if torch.device(device).type != "cuda":
        return None
    return torch.empty(1 << 30, dtype=torch.uint8, device=device)


def time_ms(fn, device, iters: int, flush=None) -> float:
    """Median ms of ``iters`` calls of ``fn()``: CUDA events around each
    call on the card (after warm-up, with ``flush`` overwritten before each
    call), the host clock on the CPU. The median, because a host stall
    longer than the flush leaves the card idle inside the events of one
    call now and then; the garbage collector is off while it times."""
    fn()
    _sync(device)
    times = []
    collecting = gc.isenabled()
    gc.disable()
    try:
        for _ in range(iters):
            if flush is not None:
                flush.zero_()
            if torch.device(device).type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
    finally:
        if collecting:
            gc.enable()
    return statistics.median(times)


def make_timer(n: int):
    """``timeit(fn, x)``: seconds of one ``fn(x)``, the median of ``n``
    calls timed as :func:`time_ms` times them on x's device."""
    flushes = {}

    def timeit(fn, x):
        device = x.device
        if device not in flushes:
            flushes[device] = flush_buffer(device)
        return time_ms(lambda: fn(x), device, n, flushes[device]) / 1e3

    return timeit


def pick_device(device: str) -> torch.device:
    """The device an example runs on: the card unless the caller asks for
    the CPU. Exits non-zero when the card is missing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"{sys.argv[0]}: no CUDA device is available; pass --device cpu "
            "to run the plain versions on the CPU"
        )
    return dev


def card_line(device) -> str:
    """What every number printed beside it was taken on: the card's name
    and power limit as nvidia-smi gives them, or the host's CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu (host clock; the plain versions, no kernel)"
    return subprocess.run(
        ["nvidia-smi", "-i", str(dev.index or 0),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def main(argv=None) -> None:
    from vptq_tpu_torch.layers.dense import DenseLinear
    from vptq_tpu_torch.layers.runtime import Int8Linear, pick_group

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n_iter", nargs="?", type=int, default=400)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = pick_device(args.device)
    print(f"# {card_line(device)}", flush=True)
    timeit = make_timer(args.n_iter)
    gen = torch.Generator(device=device).manual_seed(0)

    def lin(in_f, out_f):
        g = pick_group(in_f)
        in_p = in_f + ((-in_f) % g)
        wq = torch.randint(-127, 128, (out_f, in_p), generator=gen,
                           device=device, dtype=torch.int8)
        scales = 0.005 * (1 + torch.rand((in_p // g, out_f), generator=gen,
                                         device=device))
        return Int8Linear(wq=wq, scales=scales, bias=None)

    h, inter, vocab = 4096, 11008, 32000
    shapes = {
        "qkv": (lin(h, 3 * h), h),
        "o": (lin(h, h), h),
        "gate_up": (lin(h, 2 * inter), h),
        "down": (lin(inter, h), inter),
        "lm_head8": (lin(h, vocab), h),
    }
    head = DenseLinear(
        weight=0.01 * torch.randn((vocab, h), generator=gen, device=device
                                  ).to(torch.bfloat16),
        bias=None,
    )

    tot = 0.0
    for name, (m, in_f) in shapes.items():
        x = torch.ones((1, 1, in_f), dtype=torch.bfloat16, device=device)
        t = timeit(lambda v, mm=m: mm(v), x)
        b = m.wq.numel() + m.scales.numel() * 4
        tot += t * (32 if name != "lm_head8" else 1)
        print(f"{name:9s} {t*1e6:8.1f} us  {b/1e6:7.1f} MB "
              f"{b/t/1e9:7.1f} GB/s", flush=True)
    x = torch.ones((1, 1, h), dtype=torch.bfloat16, device=device)
    t = timeit(lambda v: head(v), x)
    b = head.weight.numel() * 2
    print(f"{'lm_head16':9s} {t*1e6:8.1f} us  {b/1e6:7.1f} MB "
          f"{b/t/1e9:7.1f} GB/s")
    print(f"# 32-layer linears sum (w/ int8 head): {tot*1e3:.2f} ms")


if __name__ == "__main__":
    main()
