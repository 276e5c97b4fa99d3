#!/usr/bin/env python3
"""Quickest proof that vptq_tpu_torch runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and ``nvidia-smi``; exits non-zero
without them, or when any phase fails. Phases:

1. build every CUDA kernel of the port from ``vptq_tpu_torch/csrc``;
2. K1 ``w8_matmul`` at the four linear shapes of Llama-3.1-8B (group
   2048), at T=1 (decode) and T=128 and T=512 (the prefill buckets the
   three requests use): the kernel held against
   its plain version ``w8_matmul_reference`` on the card, then timed
   with CUDA events (L2 flushed before each launch) beside the plain
   version and a ``torch.matmul`` yardstick;
3. end to end: a synthetic VPTQ checkpoint of Llama-3.1-8B geometry
   (``v8-k65536-0``: vector 8, 65536 centroids, no residual, norm and
   perm on, packed indices) written by the port's own writer, loaded by
   ``AutoModelForCausalLM.from_pretrained`` (int8, cuda), three greedy
   requests of 16, 128 and 512 prompt tokens and 32 new tokens each,
   with K1's launch count checked against the forward calls, finite
   logits, and the first prompt's prefill logits held against the same
   model run through ``w8_matmul_reference``; then one decode step's
   wall time against the device time of its kernels (``torch.profiler``).

The line before the last is a JSON object with one record per measured
kernel; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# Meta's public Llama-3.1-8B config.json
LLAMA31_8B = dict(
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    head_dim=128,
    rms_norm_eps=1e-5,
    rope_theta=500000.0,
    rope_scaling=(
        ("factor", 8.0),
        ("high_freq_factor", 4.0),
        ("low_freq_factor", 1.0),
        ("original_max_position_embeddings", 8192),
        ("rope_type", "llama3"),
    ),
    max_position_embeddings=131072,
    tie_word_embeddings=False,
)
# VPTQ-community v8-k65536-0 geometry
V8_K65536 = dict(
    vector_len=8, num_centroids=65536, num_res_centroids=-1,
    enable_norm=True, enable_perm=True, is_indice_packed=True,
)
# codebook spread that keeps 32 synthetic layers' activations finite
SMOKE_STD = 0.02

# K1 against its plain version: |kernel - plain| <= RTOL*|plain| +
# ATOL_FRAC*max|plain|. Both sum f32 products of the same bf16 inputs
# and differ only in summation order before the final bf16 rounding,
# so one bf16 ulp (2^-8 relative) is the expected gap; this is tighter
# than tests/test_runtime.py's rtol 2e-2, atol 5e-3*max|y|.
RTOL, ATOL_FRAC = 1e-2, 1e-3
# prefill logits through K1 vs through the plain version, 32 layers in
# bf16: max |diff| <= LOGIT_TOL * max|logits|
LOGIT_TOL = 5e-2


def _sh(cmd) -> str:
    return subprocess.run(
        cmd, capture_output=True, text=True, check=True
    ).stdout.strip()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, iters: int, flush=None) -> float:
    """Mean ms of ``fn()``: CUDA events around each call on the card
    (after warm-up, with ``flush`` overwritten before each call), the
    host clock on the CPU."""
    fn()
    _sync(device)
    total = 0.0
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
            total += start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            fn()
            total += (time.perf_counter() - t0) * 1e3
    return total / iters


def phase_build() -> float:
    """Build every kernel source of the port; returns wall seconds."""
    from vptq_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build(force=True)
    seconds = time.perf_counter() - t0
    for name, (secs, log) in built.items():
        print(f"built {name} in {secs:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    return seconds


def k1_shapes(cfg: dict):
    """(name, out, in) of the four linears of one decoder layer."""
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    heads = cfg["num_attention_heads"] + 2 * cfg["num_key_value_heads"]
    qkv = heads * cfg["head_dim"]
    return [
        ("qkv", qkv, h),
        ("o", h, cfg["num_attention_heads"] * cfg["head_dim"]),
        ("gate_up", 2 * inter, h),
        ("down", h, inter),
    ]


def phase_k1(device, shapes, tokens=(1, 128, 512), iters=20, seed=0):
    """K1 at each shape and token count: agreement, times and bound."""
    from vptq_tpu_torch.layers.runtime import pick_group
    from vptq_tpu_torch.ops.w8_matmul import w8_matmul, w8_matmul_reference

    gen = torch.Generator(device=device).manual_seed(seed)
    cuda = torch.device(device).type == "cuda"
    # 1 GiB overwritten before each timed launch evicts the 50 MB L2,
    # and keeps the card busy (~0.3 ms) while the host enqueues the
    # timed call, so host overhead does not open a gap inside the events
    flush = (
        torch.empty(1 << 30, dtype=torch.uint8, device=device)
        if cuda else None
    )
    rows = []
    for name, out_f, in_f in shapes:
        group = pick_group(in_f)
        in_p = -(-in_f // group) * group
        wq = torch.randint(
            -127, 128, (out_f, in_p), generator=gen, device=device,
            dtype=torch.int8,
        )
        scales = (
            torch.rand(
                (in_p // group, out_f), generator=gen, device=device
            ) + 0.5
        ) * 1e-2
        w_bf16 = (
            wq.float().reshape(out_f, -1, group) * scales.t()[:, :, None]
        ).reshape(out_f, in_p).to(torch.bfloat16)
        for t in tokens:
            x = torch.randn(
                (t, in_p), generator=gen, device=device
            ).to(torch.bfloat16)
            launches = w8_matmul.launches
            y = w8_matmul(x, wq, scales)
            ref = w8_matmul_reference(x, wq, scales)
            _sync(device)
            if w8_matmul.launches != launches + (1 if cuda else 0):
                raise AssertionError("w8_matmul did not count its launch")
            if y.shape != ref.shape or y.dtype != ref.dtype:
                raise AssertionError(
                    f"K1 {name} T={t}: shape or dtype differs"
                )
            yf, rf = y.float(), ref.float()
            err = (yf - rf).abs()
            limit = RTOL * rf.abs() + ATOL_FRAC * rf.abs().max()
            ok = bool(torch.all(err <= limit))
            ok = ok and bool(torch.isfinite(yf).all())
            if not ok:
                raise AssertionError(
                    f"K1 {name} T={t}: max |err| {err.max().item():.4g} "
                    "outside the tolerance"
                )
            ms = time_ms(
                lambda: w8_matmul(x, wq, scales), device, iters, flush
            )
            plain_ms = time_ms(
                lambda: w8_matmul_reference(x, wq, scales), device,
                max(iters // 4, 1), flush,
            )
            library_ms = time_ms(
                lambda: torch.matmul(x, w_bf16.t()), device, iters, flush
            )
            # each input read once, the output written once
            nbytes = (
                t * in_p * 2 + out_f * in_p + scales.numel() * 4
                + t * out_f * 2
            )
            flops = 2 * t * out_f * in_p
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            ops_ms = flops / PEAK_BF16_FLOPS * 1e3
            rows.append(dict(
                shape=name, T=t, out=out_f, in_p=in_p, group=group,
                bytes=nbytes, flops=flops,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                max_abs_err=err.max().item(),
            ))
            print("K1 " + json.dumps(rows[-1]))
        del wq, scales, w_bf16
    return rows


def phase_e2e(device, cfg: dict, vq_kwargs: dict, prompt_lens=(16, 128, 512),
              new_tokens=32, max_seq=2048, seed=0, std=SMOKE_STD):
    """Checkpoint → from_pretrained → three greedy requests; checked."""
    from vptq_tpu_torch import AutoModelForCausalLM
    from vptq_tpu_torch.layers import runtime
    from vptq_tpu_torch.models.llama import forward, init_cache
    from vptq_tpu_torch.ops.w8_matmul import w8_matmul, w8_matmul_reference
    from vptq_tpu_torch.utils.synth_checkpoint import (
        tiny_model_config,
        write_synthetic_checkpoint,
    )

    result = {}
    path = tempfile.mkdtemp(prefix="vptq_smoke_")
    try:
        t0 = time.perf_counter()
        write_synthetic_checkpoint(
            path, tiny_model_config(**cfg), vq_kwargs=vq_kwargs, seed=seed,
            std=std,
        )
        result["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine = AutoModelForCausalLM.from_pretrained(
            path, device=device, max_seq=max_seq
        )
        _sync(device)
        result["load_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(path, ignore_errors=True)

    model, gen = engine.model, engine.generator
    per_forward = 4 * model.cfg.num_hidden_layers
    rng = np.random.default_rng(seed)
    prompts = [
        rng.integers(0, cfg["vocab_size"], n).tolist() for n in prompt_lens
    ]
    cuda = torch.device(device).type == "cuda"

    requests = []
    launches = 0
    for prompt in prompts:
        stamps = []
        w8_matmul.launches = 0
        t0 = time.perf_counter()
        out = engine.generate(
            prompt, max_new_tokens=new_tokens,
            stream_callback=lambda _tok: stamps.append(time.perf_counter()),
        )
        _sync(device)
        t_end = time.perf_counter()
        n_launch = w8_matmul.launches
        chunks = math.ceil(len(prompt) / gen.prompt_buckets[-1])
        forwards = chunks + len(out) - 1
        expected = per_forward * forwards if cuda else 0
        if n_launch != expected:
            raise AssertionError(
                f"K1 launched {n_launch} times, expected {expected} "
                f"({forwards} forward calls)"
            )
        in_vocab = all(0 <= t < cfg["vocab_size"] for t in out)
        if len(out) != new_tokens or not in_vocab:
            raise AssertionError(f"bad tokens {out}")
        launches += n_launch
        requests.append(dict(
            prompt=len(prompt), new=len(out), k1_launches=n_launch,
            ttft_s=stamps[0] - t0,
            decode_tok_s=(len(out) - 1) / (t_end - stamps[0]),
        ))
        print("request " + json.dumps(requests[-1]))
    result["requests"] = requests
    result["k1_launches"] = launches

    # logits: finite for every prompt; the first through K1 and through
    # the plain version
    def prefill(prompt):
        bucket = next(b for b in gen.prompt_buckets if len(prompt) <= b)
        tokens = torch.zeros((1, bucket), dtype=torch.int64)
        tokens[0, : len(prompt)] = torch.tensor(prompt)
        cache = init_cache(model.cfg, 1, max_seq, gen.dtype, device)
        with torch.inference_mode():
            logits, _ = forward(
                model, tokens.to(device), cache, dtype=gen.dtype,
                fresh_prefill=True,
            )
        return logits[0, : len(prompt)]

    for prompt in prompts:
        if not bool(torch.isfinite(prefill(prompt)).all()):
            raise AssertionError(
                f"non-finite logits for a {len(prompt)}-token prompt"
            )
    got = prefill(prompts[0])
    with mock.patch.object(runtime, "w8_matmul", w8_matmul_reference):
        want = prefill(prompts[0])
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    result["logits_max_abs_diff"] = diff
    result["logits_max_abs"] = scale
    if not diff <= LOGIT_TOL * scale:
        raise AssertionError(f"prefill logits differ by {diff} (max {scale})")

    if cuda:
        result["decode_step"] = decode_breakdown(model, gen, prompts[0])
        # K8 (flash attention) is not ported: a long fresh prefill must
        # refuse rather than run a plain fallback
        cache = init_cache(model.cfg, 1, max_seq, gen.dtype, device)
        try:
            with torch.inference_mode():
                forward(
                    model,
                    torch.zeros((1, 1024), dtype=torch.int64, device=device),
                    cache, dtype=gen.dtype, fresh_prefill=True,
                )
        except NotImplementedError as e:
            if "K8" not in str(e):
                raise
        else:
            raise AssertionError("a 1024-token fresh prefill did not raise")
    del engine, model
    return result


def decode_breakdown(model, gen, prompt, steps=8):
    """Wall time of one batch-1 decode step (host clock, synchronized)
    against the device time of the kernels it runs (``torch.profiler``
    CUDA activity, taken over the same steps run again)."""
    from torch.profiler import ProfilerActivity, profile

    from vptq_tpu_torch.models.llama import forward, init_cache

    device = model.embed_tokens.device
    cache = init_cache(model.cfg, 1, gen.max_seq, gen.dtype, device)
    tok = torch.tensor([prompt], dtype=torch.int64, device=device)

    def run(n):
        nonlocal tok
        for _ in range(n):
            logits, _ = forward(model, tok, cache, dtype=gen.dtype)
            tok = torch.argmax(logits[:, -1:], dim=-1)
        torch.cuda.synchronize(device)

    with torch.inference_mode():
        run(1)  # the prompt, then warm-up
        run(steps)
        t0 = time.perf_counter()
        run(steps)
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(steps)
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / steps
    k1_ms = sum(
        e.device_time_total for e in kernels if "w8_gem" in e.name
    ) / 1e3 / steps
    out = dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms, k1_ms=k1_ms,
        kernels_per_step=len(kernels) / steps,
        idle_share=1.0 - busy_ms / wall_ms,
    )
    print("decode step " + json.dumps(out))
    return out


def kernel_records(rows, launches):
    """The contract's per-kernel records: K1 at decode and at prefill,
    each summed over one layer's four linears."""
    out = []
    for t in sorted({r["T"] for r in rows}):
        sel = [r for r in rows if r["T"] == t]
        bytes_ms = sum(r["bytes"] for r in sel) / PEAK_BYTES_PER_S * 1e3
        ops_ms = sum(r["flops"] for r in sel) / PEAK_BF16_FLOPS * 1e3
        out.append({
            "name": f"w8_matmul (T={t}, one layer's 4 linears)",
            "route": "cuda",
            "source": "vptq_tpu_torch/csrc/w8_matmul.cu",
            "replaces": "vptq_tpu/ops/pallas_gemm.py:58",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in sel),
            "ms": sum(r["ms"] for r in sel),
            "plain_ms": sum(r["plain_ms"] for r in sel),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": sum(r["library_ms"] for r in sel),
            "library": "torch.matmul of bf16 x with the dequantized bf16 "
                       "weight: a yardstick that reads twice the weight "
                       "bytes; the port never calls it",
        })
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import vptq_tpu_torch  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(_sh([
        "nvidia-smi", "--query-gpu=name,power.limit",
        "--format=csv,noheader",
    ]))
    from vptq_tpu_torch.ops import _build

    print(_sh([_build.nvcc_path(), "--version"]))
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    build_s = phase_build()
    print(f"kernel build: {build_s:.2f} s")
    print("kernels: " + ", ".join(
        f"{n} (vptq_tpu_torch/csrc/{n}.cu)" for n in _build.SOURCES
    ))

    device = "cuda"
    print(
        f"K1 vs plain tolerance: |err| <= {RTOL} * |plain| + {ATOL_FRAC} * "
        f"max|plain|; prefill logits: max|diff| <= {LOGIT_TOL} * max|logit|"
    )
    rows = phase_k1(device, k1_shapes(LLAMA31_8B))
    e2e = phase_e2e(device, LLAMA31_8B, V8_K65536)
    print("e2e " + json.dumps(e2e))
    print(json.dumps({"kernels": kernel_records(rows, e2e["k1_launches"])}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
