"""Decode-step cost breakdown on the card (--int8 / --int4 / --int3 / --int2).

Port of ``examples/profile_decode.py``. The model is a synthetic VPTQ
checkpoint of Llama-3.1-8B width (Meta's ``config.json``; the community
``v8-k65536-0`` geometry), written by the package's own writer and
loaded in the chosen runtime format, all 32 layers. Times, after the
card's name and power limit:

* each linear of one layer at one token (qkv / o / gate_up / down):
  µs, the MB it holds, GB/s, and × the layers; the lm_head (bf16,
  ``torch.matmul``); the sum of the linears over a step. Each is the
  median of CUDA events around one call, after a read of 1 GiB that
  leaves the L2 clean, as a decode step finds it;
* the full decode step through the generator's CUDA graphs and the same
  step eager (``decode_loop``), greedy from a 16-token prompt: ms a
  token (host clock over 64 steps, synchronized), tok/s, and what is
  left outside the linears.

    python -m vptq_tpu_torch.examples.profile_decode [--int4] [--checkpoint DIR]

``--checkpoint`` keeps the written checkpoint in DIR and reads it from
there when it is there already (one write serves every format).

Without a CUDA device it exits non-zero, unless given ``--device cpu``
(the plain versions on the host clock; ``--tiny`` for a small model).
"""

from __future__ import annotations

import argparse
import gc
import shutil
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from vptq_tpu_torch.examples.kernel_bench import card_line, pick_device

__all__ = ["LLAMA31_8B", "main"]

# Meta's public Llama-3.1-8B config.json
LLAMA31_8B = dict(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    head_dim=128, rms_norm_eps=1e-5, rope_theta=500000.0,
    rope_scaling=(
        ("factor", 8.0), ("high_freq_factor", 4.0), ("low_freq_factor", 1.0),
        ("original_max_position_embeddings", 8192), ("rope_type", "llama3"),
    ),
    max_position_embeddings=131072, tie_word_embeddings=False,
)
# a width the CPU runs in seconds, for a rehearsal
TINY = dict(
    vocab_size=256, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    head_dim=16, tie_word_embeddings=False,
)
# VPTQ-community v8-k65536-0 geometry
V8_K65536 = dict(
    vector_len=8, num_centroids=65536, num_res_centroids=-1,
    enable_norm=True, enable_perm=True, is_indice_packed=True,
)
FORMATS = ("int8", "int4", "int3", "int2")
ITERS, STEPS = 50, 64


def _ms(fn, device, iters: int, flush) -> float:
    """Median ms of ``iters`` calls of ``fn()``: CUDA events around each,
    after a read of ``flush`` (1 GiB) that evicts the L2 and writes
    nothing back; the host clock on the CPU."""
    fn()
    cuda = device.type == "cuda"
    if cuda:
        sink = torch.zeros((), dtype=torch.int64, device=device)
        words = flush.view(torch.int32)
        torch.cuda.synchronize(device)
    times = []
    collecting = gc.isenabled()
    gc.disable()
    try:
        for _ in range(iters):
            if cuda:
                sink.copy_(words.sum())
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


def _step_ms(prepare, run, device, steps: int, reps: int = 3) -> float:
    """The least over ``reps`` of the host-clock ms a step of ``run()``
    (``steps`` steps after ``prepare()``, synchronized before and
    after)."""
    best = float("inf")
    for _ in range(reps):
        prepare()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        best = min(best, (time.perf_counter() - t0) * 1e3 / steps)
    return best


def _nbytes(module) -> int:
    return sum(b.numel() * b.element_size() for b in module.buffers())


def main(argv=None) -> None:
    from vptq_tpu_torch.models.llama import forward
    from vptq_tpu_torch.models.loader import load_model
    from vptq_tpu_torch.serving.generate import Generator, decode_loop
    from vptq_tpu_torch.utils.synth_checkpoint import (
        tiny_model_config,
        write_synthetic_checkpoint,
    )

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for fmt in FORMATS[1:]:
        parser.add_argument(f"--{fmt}", dest="fmt", action="store_const",
                            const=fmt)
    parser.add_argument("--int8", dest="fmt", action="store_const",
                        const="int8")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--checkpoint", default=None)
    args = parser.parse_args(argv)
    fmt = args.fmt or "int8"
    device = pick_device(args.device)
    print(f"# {card_line(device)}", flush=True)

    cfg = dict(TINY if args.tiny else LLAMA31_8B)
    layers = cfg["num_hidden_layers"]
    path = args.checkpoint or tempfile.mkdtemp(prefix="vptq_profile_")
    try:
        t0 = time.perf_counter()
        if not (Path(path) / "config.json").exists():
            write_synthetic_checkpoint(
                path, tiny_model_config(**cfg),
                vq_kwargs=None if args.tiny else V8_K65536, seed=0, std=0.02,
            )
        model = load_model(path, runtime_format=fmt, device=device)
    finally:
        if args.checkpoint is None:
            shutil.rmtree(path, ignore_errors=True)
    print(f"# {fmt}, {layers} layers of Llama-3.1-8B width"
          f"{' (tiny)' if args.tiny else ''}: written and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    flush = (torch.empty(1 << 30, dtype=torch.uint8, device=device)
             if device.type == "cuda" else None)
    block = model.blocks[0]
    hidden, inter = cfg["hidden_size"], cfg["intermediate_size"]
    x = torch.ones((1, 1, hidden), dtype=torch.bfloat16, device=device)
    xi = torch.ones((1, 1, inter), dtype=torch.bfloat16, device=device)
    linears = {
        "qkv": (block.attn.qkv_proj, x), "o": (block.attn.o_proj, x),
        "gate_up": (block.mlp.gate_up_proj, x), "down": (block.mlp.down_proj, xi),
    }
    total_ms = total_bytes = 0.0
    with torch.inference_mode():
        for name, (lin, inp) in linears.items():
            ms = _ms(lambda m=lin, v=inp: m(v), device, ITERS, flush)
            nbytes = _nbytes(lin)
            total_ms += ms * layers
            total_bytes += nbytes * layers
            print(f"{name:8s} {ms * 1e3:8.1f} us  {nbytes / 1e6:7.1f} MB "
                  f"{nbytes / ms / 1e6:7.1f} GB/s  x{layers}: "
                  f"{ms * layers:.3f} ms", flush=True)
        ms = _ms(lambda: model.lm_head(x), device, ITERS, flush)
        nbytes = _nbytes(model.lm_head)
        total_ms += ms
        total_bytes += nbytes
        print(f"{'lm_head':8s} {ms * 1e3:8.1f} us  {nbytes / 1e6:7.1f} MB "
              f"{nbytes / ms / 1e6:7.1f} GB/s", flush=True)
        print(f"linears sum: {total_ms:.3f} ms/tok ({total_bytes / 1e9:.2f} "
              f"GB @ {total_bytes / total_ms / 1e6:.0f} GB/s)", flush=True)

        gen = Generator(model, max_seq=2048)
        cache = gen.cache
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg["vocab_size"], (1, 16)))
        first = torch.ones(1, dtype=torch.int64, device=device)
        steps = STEPS

        def prefilled():
            cache.reset(0)
            forward(model, prompt.to(device), cache, fresh_prefill=True)
            cache.reset(prompt.shape[1])

        def graphed():
            gen.graphs.run(first, steps, 0.0, 0)

        def eager():
            decode_loop(model, first, cache, None, 0.0, steps=steps)

        rows = [("eager", eager)]
        if gen.graphs is not None:
            prefilled()
            graphed()  # captures the step's graph
            rows.insert(0, ("graphed", graphed))
        else:
            print("graphed step: not on the CPU (no CUDA graphs)")
        for what, run in rows:
            step = _step_ms(prefilled, run, device, steps)
            print(f"full step ({what}): {step:.3f} ms/tok "
                  f"({1e3 / step:.1f} tok/s); outside the linears: "
                  f"{step - total_ms:.3f} ms/tok", flush=True)
    print(f"# {card_line(device)}", flush=True)


if __name__ == "__main__":
    main()
