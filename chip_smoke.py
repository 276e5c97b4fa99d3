#!/usr/bin/env python3
"""Quickest proof that vptq_tpu_torch runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and ``nvidia-smi``; exits non-zero
without them, or when any phase fails. Phases:

1. build every CUDA kernel of the port from ``vptq_tpu_torch/csrc`` (K1
   ``w8_matmul``, K2 ``w4_matmul``, K3 ``w2_matmul``, K4 ``w3_matmul``,
   the MoE kernels K6a ``w8_matmul_expert``, K5a ``w8_matmul_pairs``,
   K6b ``w4_matmul_expert``, K5b ``w4_matmul_pairs``, K8
   ``flash_attention`` and K7 ``bf16_matmul``), one ``nvcc`` each, all at
   once;
2. each of K1-K4 at the four linear shapes of Llama-3.1-8B, on layers its
   format's encoder makes on the card from a random weight (K1 group
   2048, K3 group 64), at T=1 (decode) and T=128 and T=512 (prefill
   buckets): the kernel held against its plain version on the card, then
   timed with CUDA events (L2 flushed before each launch) beside the
   plain version and a ``torch.matmul`` yardstick; K1 also at the four
   shapes of Qwen2.5-7B (group 512; intermediate 18944 padded to 19456);
   K7 at the Llama shapes on a random bf16 weight; K8 at Llama-3.1-8B's
   heads (32 over 8 KV heads of 128) on N(0, 1) q, k, v with v a strided
   view into a fused q|k|v row, at S=1024, 2048 and 1100 (no tile divides
   it), at head size 64, and with scores scaled to about +-50, beside
   ``scaled_dot_product_attention`` as its yardstick;
3. the MoE kernels at Mixtral-8x7B's two expert shapes (gate_up
   28672 x 4096, down 4096 x 14336) on stacks of 8 experts that the int8
   and int4 encoders make on the card: K6a / K6b at T=1, 128 and 512 (one
   expert, the last of the stack), K5a / K5b at P=2 (one token's top-2)
   and P=16 (8 tokens' top-2) pairs, each against its plain version and
   timed like phase 2, the bound counting the distinct experts read;
   yardsticks ``torch.matmul`` with one expert's dequantized bf16 weight
   and ``torch.bmm`` over the gathered experts;
4. the int4, int3 and int2 encoders on the card against the same
   encoders on the CPU, byte for byte, on one 4096 x 4096 synthetic
   weight (the CPU encoders are held to the JAX package's numpy bytes by
   the CPU tests);
5. end to end, once per format (int8, int4, int3, int2): one synthetic
   VPTQ checkpoint of Llama-3.1-8B geometry (``v8-k65536-0``: vector 8,
   65536 centroids, no residual, norm and perm on, packed indices),
   written once by the port's own writer, loaded by
   ``AutoModelForCausalLM.from_pretrained(runtime_format=...)`` on cuda;
   four greedy requests of 16, 128, 512 and 1536 prompt tokens and 32
   new tokens each, with every kernel's launch count set to 0 before and
   checked after (the format's kernel 4 per layer per forward call; K8
   once per layer for the 1536-token prompt, whose fresh 2048-token chunk
   it serves, and 0 for the shorter prompts; the others 0), finite
   logits, and the first prompt's prefill logits held against the same
   model run through the plain version (in int8 the long prompt's too,
   K8 swapped for its plain version with K1); then one decode step's
   wall time against the device time of its kernels (``torch.profiler``),
   and the same for the long prompt's prefill;
6. end to end in int8 and in int4 on one synthetic checkpoint of
   Mixtral-8x7B-v0.1 geometry (full width, 8 experts, top-2; depth as
   ``MIXTRAL_8X7B`` says), the same four requests: per layer and forward
   call 2 launches of K1 / K2 (qkv, o), per layer and decode step 2 of
   K5, per layer and prefill chunk 16 of K6, K8 as above, every other
   kernel 0; the
   first prompt's prefill logits, and one decode step's, through the
   kernels against the plain versions; the profiled decode steps must
   hold no device-to-host copy (the expert ids stay on the card);
7. end to end in int8 on one synthetic checkpoint of Qwen2.5-7B geometry
   (a bias on q, k and v; K1's first widths that pad), the same four
   requests, the long prompt's logits against the plain versions;
8. end to end in int8 on one synthetic checkpoint of Mistral-7B-v0.1
   geometry (sliding window 4096) with ``max_seq`` 8192: prompts of 16,
   512, 1536 and 4608 tokens (three chunks; positions from 4096 on lose
   their oldest keys). The window keeps every chunk out of K8, which
   must count 0.

The line before the last is a JSON object with one record per kernel at
T=1 and T=512 (pairs kernels: P=2 and P=16; K8: S=1024 and S=2048); the
last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import importlib
import json
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
# mistralai's public Mixtral-8x7B-v0.1 config.json (sliding_window null)
MIXTRAL_8X7B = dict(
    model_type="mixtral",
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    head_dim=128,
    rms_norm_eps=1e-5,
    rope_theta=1e6,
    max_position_embeddings=32768,
    num_local_experts=8,
    num_experts_per_tok=2,
    tie_word_embeddings=False,
)
# Qwen's public Qwen2.5-7B config.json (use_sliding_window false, so no
# window; q, k and v carry a bias)
QWEN25_7B = dict(
    model_type="qwen2",
    vocab_size=152064,
    hidden_size=3584,
    intermediate_size=18944,
    num_hidden_layers=28,
    num_attention_heads=28,
    num_key_value_heads=4,
    head_dim=128,
    rms_norm_eps=1e-6,
    rope_theta=1e6,
    max_position_embeddings=131072,
    tie_word_embeddings=False,
)
# mistralai's public Mistral-7B-v0.1 config.json
MISTRAL_7B = dict(
    model_type="mistral",
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    head_dim=128,
    rms_norm_eps=1e-5,
    rope_theta=10000.0,
    max_position_embeddings=32768,
    sliding_window=4096,
    tie_word_embeddings=False,
)
# VPTQ-community v8-k65536-0 geometry
V8_K65536 = dict(
    vector_len=8, num_centroids=65536, num_res_centroids=-1,
    enable_norm=True, enable_perm=True, is_indice_packed=True,
)
# codebook spread that keeps 32 synthetic layers' activations finite
SMOKE_STD = 0.02

# a kernel against its plain version: |kernel - plain| <= RTOL*|plain| +
# ATOL_FRAC*max|plain|. Both sum f32 products of the same bf16 inputs
# and exact levels, scale each group's f32 partial, and differ only in
# summation order before the final bf16 rounding, so one bf16 ulp
# (2^-8 relative) is the expected gap; this is tighter than
# tests/test_runtime.py's rtol 2e-2, atol 5e-3*max|y|.
RTOL, ATOL_FRAC = 1e-2, 1e-3
# prefill logits through a kernel vs through its plain version, 32
# layers in bf16: max |diff| <= LOGIT_TOL * max|logits|
LOGIT_TOL = 5e-2
# runtime format -> the kernel that carries every decoder linear
FORMAT_KERNEL = {
    "int8": "w8_matmul", "int4": "w4_matmul", "int3": "w3_matmul",
    "int2": "w2_matmul",
}
# runtime format -> the (expert, pairs) kernels of its stacked MoE experts
MOE_KERNELS = {
    "int8": ("w8_matmul_expert", "w8_matmul_pairs"),
    "int4": ("w4_matmul_expert", "w4_matmul_pairs"),
}
FLASH, BF16 = "flash_attention", "bf16_matmul"
ALL_KERNELS = (
    *FORMAT_KERNEL.values(), *sum(MOE_KERNELS.values(), ()), FLASH, BF16,
)
# K8 against its plain version: max |err| <= FLASH_TOL * max|plain|. Both
# sum f32 products of the same bf16 inputs, keep max and sum in f32, round
# p to bf16 before p.v and the result to bf16 once; they differ in
# summation order, in exp2 against exp, and so now and then in which way
# a rounding of p or of the result falls: one to two bf16 ulps (2^-8) at
# the largest magnitude.
FLASH_TOL = 2.0 ** -7


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


def kernel_fns(name):
    """(kernel wrapper, plain version) of one kernel module."""
    mod = importlib.import_module(f"vptq_tpu_torch.ops.{name}")
    return getattr(mod, name), getattr(mod, f"{name}_reference")


def make_layer(name, gen, out_f, in_f, device):
    """The runtime layer that kernel ``name``'s format encoder makes from
    one random f32 (out, in) weight on ``device`` (K1 group from
    ``pick_group``, K3 group 64, the padding the encoders apply)."""
    from vptq_tpu_torch.layers import runtime as rt

    fmt = next(f for f, k in FORMAT_KERNEL.items() if k == name)
    w = torch.randn((out_f, in_f), generator=gen, device=device) * SMOKE_STD
    return getattr(rt, f"_encode_{fmt}")(w, None)


def flush_buffer(device):
    """1 GiB overwritten before each timed launch evicts the 50 MB L2, and
    keeps the card busy (~0.3 ms) while the host enqueues the timed call,
    so host overhead does not open a gap inside the events."""
    if torch.device(device).type != "cuda":
        return None
    return torch.empty(1 << 30, dtype=torch.uint8, device=device)


def check_and_time(name, label, call, plain, library, nbytes, flops, device,
                   iters, flush, rtol=RTOL, atol_frac=ATOL_FRAC):
    """One kernel call against its plain version on the same inputs
    (|err| <= rtol * |plain| + atol_frac * max|plain|), then the times of
    both and of the library yardstick beside the bound for ``nbytes``
    moved and ``flops`` done."""
    fn = kernel_fns(name)[0]
    cuda = torch.device(device).type == "cuda"
    launches = fn.launches
    y = call()
    want = plain()
    _sync(device)
    if fn.launches != launches + (1 if cuda else 0):
        raise AssertionError(f"{name} did not count its launch")
    if y.shape != want.shape or y.dtype != want.dtype:
        raise AssertionError(f"{name} {label}: shape or dtype differs")
    yf, rf = y.float(), want.float()
    err = (yf - rf).abs()
    limit = rtol * rf.abs() + atol_frac * rf.abs().max()
    if not (bool(torch.all(err <= limit))
            and bool(torch.isfinite(yf).all())):
        raise AssertionError(
            f"{name} {label}: max |err| {err.max().item():.4g} outside "
            "the tolerance"
        )
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    return dict(
        bytes=nbytes, flops=flops, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        ms=time_ms(call, device, iters, flush),
        plain_ms=time_ms(plain, device, max(iters // 4, 1), flush),
        library_ms=time_ms(library, device, iters, flush),
        max_abs_err=err.max().item(),
    )


def phase_kernel(name, device, shapes, tokens=(1, 128, 512), iters=20,
                 seed=0, in_record=True):
    """One kernel at each shape and token count: agreement with its
    plain version, times and bound. ``in_record``: whether the rows go
    into the kernel's record (one model's layer) or stand alone."""
    from vptq_tpu_torch.layers.runtime import linear_exact_weight

    fn, ref = kernel_fns(name)
    gen = torch.Generator(device=device).manual_seed(seed)
    flush = flush_buffer(device)
    rows = []
    for shape, out_f, in_f in shapes:
        layer = make_layer(name, gen, out_f, in_f, device)
        args = tuple(layer.buffers())
        w_bf16 = linear_exact_weight(layer).to(torch.bfloat16)
        in_p = w_bf16.shape[1]
        arg_bytes = sum(a.numel() * a.element_size() for a in args)
        for t in tokens:
            x = torch.randn(
                (t, in_p), generator=gen, device=device
            ).to(torch.bfloat16)
            rows.append(dict(
                kernel=name, shape=shape, unit="T", T=t, out=out_f,
                in_p=in_p, group=getattr(layer, "group", 128),
                in_record=in_record,
                **check_and_time(
                    name, f"{shape} T={t}",
                    lambda: fn(x, *args), lambda: ref(x, *args),
                    lambda: torch.matmul(x, w_bf16.t()),
                    # each input read once, the output written once
                    t * in_p * 2 + arg_bytes + t * out_f * 2,
                    2 * t * out_f * in_p, device, iters, flush,
                ),
            ))
            print(f"{name} " + json.dumps(rows[-1]))
        del layer, args, w_bf16
    return rows


def phase_bf16(device, shapes, tokens=(1, 128, 512), iters=20, seed=0):
    """K7 at each shape and token count on a random bf16 weight against
    its plain version; the yardstick is ``torch.matmul`` on the same
    tensors."""
    fn, ref = kernel_fns(BF16)
    gen = torch.Generator(device=device).manual_seed(seed)
    flush = flush_buffer(device)
    rows = []
    for shape, out_f, in_f in shapes:
        w = (torch.randn((out_f, in_f), generator=gen, device=device)
             * SMOKE_STD).to(torch.bfloat16)
        for t in tokens:
            x = torch.randn(
                (t, in_f), generator=gen, device=device
            ).to(torch.bfloat16)
            rows.append(dict(
                kernel=BF16, shape=shape, unit="T", T=t, out=out_f, in_p=in_f,
                **check_and_time(
                    BF16, f"{shape} T={t}",
                    lambda: fn(x, w), lambda: ref(x, w),
                    lambda: torch.matmul(x, w.t()),
                    # x and w read once, y written once
                    2 * (t * in_f + out_f * in_f + t * out_f),
                    2 * t * out_f * in_f, device, iters, flush,
                ),
            ))
            print(f"{BF16} " + json.dumps(rows[-1]))
        del w
    return rows


# (label, B, S, H, KV, D, factor on q and k, in the kernel's record)
FLASH_CASES = (
    ("llama-3.1-8b heads", 1, 1024, 32, 8, 128, 1.0, True),
    ("llama-3.1-8b heads", 1, 2048, 32, 8, 128, 1.0, True),
    ("no tile divides S", 1, 1100, 32, 8, 128, 1.0, False),
    ("head size 64, two sequences", 2, 1100, 8, 2, 64, 1.0, False),
    # q.k / sqrt(D) ~ N(0, 12^2): scores reach about +-50
    ("scores to +-50", 1, 1024, 32, 8, 128, 12.0 ** 0.5, False),
)


def phase_flash(device, cases=FLASH_CASES, iters=20, seed=0):
    """K8 on N(0, 1) q, k, v in bf16, v a strided view into a fused
    q|k|v row as the model gives it, against its plain version; the
    yardstick is ``scaled_dot_product_attention`` on the same tensors,
    which the port never calls."""
    import torch.nn.functional as F

    fn, ref = kernel_fns(FLASH)
    gen = torch.Generator(device=device).manual_seed(seed)
    flush = flush_buffer(device)
    rows = []
    for label, batch, seq, heads, kv_heads, dim, factor, in_record in cases:
        widths = [heads * dim, kv_heads * dim, kv_heads * dim]
        qkv = torch.randn(
            (batch, seq, sum(widths)), generator=gen, device=device
        )
        q, k, v = torch.split(qkv.to(torch.bfloat16), widths, dim=-1)
        q = (q * factor).reshape(batch, seq, heads, dim).contiguous()
        k = (k * factor).reshape(batch, seq, kv_heads, dim).contiguous()
        v = v.reshape(batch, seq, kv_heads, dim)
        scale = dim ** -0.5
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True, scale=scale
            )

        elems = q.numel() * 2 + k.numel() + v.numel()  # q, out, k, v
        rows.append(dict(
            kernel=FLASH, shape=label, unit="S", T=seq, batch=batch,
            heads=heads, kv_heads=kv_heads, head_dim=dim,
            v_row_stride=v.stride(1), in_record=in_record,
            **check_and_time(
                FLASH, f"{label} S={seq}",
                lambda: fn(q, k, v, scale), lambda: ref(q, k, v, scale),
                library,
                # q and out at H heads, k and v at KV heads, once each
                2 * elems,
                # the lower triangle with its diagonal, both products
                4 * dim * heads * batch * seq * (seq + 1) // 2,
                device, iters, flush, rtol=0.0, atol_frac=FLASH_TOL,
            ),
        ))
        print(f"{FLASH} " + json.dumps(rows[-1]))
        del qkv, q, k, v, qt, kt, vt
    return rows


def moe_shapes(cfg: dict):
    """(name, out, in) of the two stacked expert weights of a MoE layer."""
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    return [("gate_up", 2 * inter, h), ("down", h, inter)]


def phase_moe_kernels(fmt, device, shapes, n_experts=8, tokens=(1, 128, 512),
                      pairs=(2, 16), top_k=2, iters=20, seed=0):
    """The expert (K6) and pairs (K5) kernels of ``fmt`` at each shape, on
    a stack of ``n_experts`` that the format's encoder makes on ``device``:
    the expert kernel on the stack's last expert at each token count, the
    pairs kernel on the top-``top_k`` ids of P / ``top_k`` tokens (distinct
    per token, drawn from ``seed``)."""
    from vptq_tpu_torch.layers.runtime import (
        linear_exact_weight,
        stack_experts,
    )
    from vptq_tpu_torch.models.llama import Mlp

    e_name, p_name = MOE_KERNELS[fmt]
    (e_fn, e_ref), (p_fn, p_ref) = kernel_fns(e_name), kernel_fns(p_name)
    dense = FORMAT_KERNEL[fmt]
    gen = torch.Generator(device=device).manual_seed(seed)
    cpu_gen = torch.Generator().manual_seed(seed)
    flush = flush_buffer(device)
    rows = []
    for shape, out_f, in_f in shapes:
        layers = [
            make_layer(dense, gen, out_f, in_f, device)
            for _ in range(n_experts)
        ]
        # the dequantized experts, for the library yardsticks only
        w_bf16 = torch.stack([
            linear_exact_weight(m).to(torch.bfloat16) for m in layers
        ])
        group = getattr(layers[0], "group", 128)
        # stack_experts stacks gate_up and down alike: one call, same layers
        stacked = stack_experts([Mlp(None, None, m, m) for m in layers])
        wq, scales = stacked.down_wq, stacked.down_scales
        del layers, stacked
        in_p = w_bf16.shape[2]
        slab = (wq[0].numel() * wq.element_size()
                + scales[0].numel() * scales.element_size())
        last = torch.tensor(n_experts - 1, dtype=torch.int32, device=device)
        w_last = w_bf16[n_experts - 1]
        for t in tokens:
            x = torch.randn(
                (t, in_p), generator=gen, device=device
            ).to(torch.bfloat16)
            rows.append(dict(
                kernel=e_name, shape=shape, unit="T", T=t, out=out_f,
                in_p=in_p, group=group, experts=n_experts, distinct=1,
                **check_and_time(
                    e_name, f"{shape} T={t}",
                    lambda: e_fn(x, wq, scales, last),
                    lambda: e_ref(x, wq, scales, last),
                    lambda: torch.matmul(x, w_last.t()),
                    # x, one expert's slab and its id read, y written
                    t * in_p * 2 + slab + 4 + t * out_f * 2,
                    2 * t * out_f * in_p, device, iters, flush,
                ),
            ))
            print(f"{e_name} " + json.dumps(rows[-1]))
        for n_pairs in pairs:
            ids = torch.cat([
                torch.randperm(n_experts, generator=cpu_gen)[:top_k]
                for _ in range(n_pairs // top_k)
            ])
            distinct = len(set(ids.tolist()))
            ids = ids.to(device=device, dtype=torch.int32)
            ids64 = ids.to(torch.int64)
            x = torch.randn(
                (n_pairs, in_p), generator=gen, device=device
            ).to(torch.bfloat16)
            rows.append(dict(
                kernel=p_name, shape=shape, unit="P", T=n_pairs, out=out_f,
                in_p=in_p, group=group, experts=n_experts, distinct=distinct,
                **check_and_time(
                    p_name, f"{shape} P={n_pairs}",
                    lambda: p_fn(x, wq, scales, ids),
                    lambda: p_ref(x, wq, scales, ids),
                    lambda: torch.bmm(
                        x[:, None, :],
                        w_bf16.index_select(0, ids64).transpose(1, 2),
                    ),
                    # each distinct expert's slab counted once, however
                    # many pairs pick it
                    n_pairs * (in_p * 2 + 4 + out_f * 2) + distinct * slab,
                    2 * n_pairs * out_f * in_p, device, iters, flush,
                ),
            ))
            print(f"{p_name} " + json.dumps(rows[-1]))
        del wq, scales, w_bf16, w_last
    return rows


def phase_encoders(device, out_f=4096, in_f=4096, seed=0):
    """int4 / int3 / int2 encodings of one synthetic weight on ``device``
    against the same encoders on the CPU, byte for byte. The weight is
    built the VQ way (8-vectors gathered from a 4096-entry codebook), so
    it repeats values as a dequantized checkpoint does."""
    from vptq_tpu_torch.layers import runtime as rt

    rng = np.random.default_rng(seed)
    codebook = (rng.standard_normal((4096, 8)) * SMOKE_STD).astype(np.float32)
    ids = rng.integers(0, 4096, (out_f, in_f // 8))
    w = torch.from_numpy(codebook[ids].reshape(out_f, in_f))
    result = {}
    for fmt in ("int4", "int3", "int2"):
        encode = getattr(rt, f"_encode_{fmt}")
        t0 = time.perf_counter()
        got = encode(w.to(device), None)
        _sync(device)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = encode(w, None)
        cpu_s = time.perf_counter() - t0
        for (name, g), (_, wnt) in zip(
            got.named_buffers(), want.named_buffers()
        ):
            if not torch.equal(g.cpu().view(torch.uint8),
                               wnt.view(torch.uint8)):
                raise AssertionError(
                    f"{fmt} {name}: the card's bytes differ from the CPU's"
                )
        result[fmt] = dict(card_s=card_s, cpu_s=cpu_s)
        print(f"encoder {fmt} " + json.dumps(result[fmt]))
    return result


def write_checkpoint(cfg: dict, vq_kwargs: dict, seed=0, std=SMOKE_STD,
                     qkv_bias=False):
    """The synthetic checkpoint every format loads; returns (dir, s)."""
    from vptq_tpu_torch.utils.synth_checkpoint import (
        tiny_model_config,
        write_synthetic_checkpoint,
    )

    path = tempfile.mkdtemp(prefix="vptq_smoke_")
    t0 = time.perf_counter()
    write_synthetic_checkpoint(
        path, tiny_model_config(**cfg), vq_kwargs=vq_kwargs, seed=seed,
        std=std, qkv_bias=qkv_bias,
    )
    return path, time.perf_counter() - t0


def expected_launches(cfg, fmt: str, prompt_len: int, new_tokens: int,
                      buckets) -> dict:
    """Launches of every kernel in one request on the card: the prompt in
    bucket-padded chunks, then one forward call per further token. The
    first chunk, when it holds 1024 tokens or more and the model has no
    sliding window, goes through K8 once per layer. A MoE block sends a
    call of at most 64 tokens through the pairs kernel twice, and a
    longer one through the expert kernel 2·E times. K7 is on no path."""
    from vptq_tpu_torch.models.llama import (
        _FLASH_MIN_SEQ,
        _MOE_FAST_MAX_TOKENS,
    )
    from vptq_tpu_torch.serving.generate import _pad_bucket

    layers = cfg.num_hidden_layers
    calls = [
        _pad_bucket(min(buckets[-1], prompt_len - done), buckets)
        for done in range(0, prompt_len, buckets[-1])
    ] + [1] * (new_tokens - 1)
    expected = dict.fromkeys(ALL_KERNELS, 0)
    if calls[0] >= _FLASH_MIN_SEQ and cfg.sliding_window is None:
        expected[FLASH] = layers
    if not cfg.num_local_experts:
        expected[FORMAT_KERNEL[fmt]] = 4 * layers * len(calls)
        return expected
    expert, pairs = MOE_KERNELS[fmt]
    fast = sum(n <= _MOE_FAST_MAX_TOKENS for n in calls)
    expected[FORMAT_KERNEL[fmt]] = 2 * layers * len(calls)
    expected[pairs] = 2 * layers * fast
    expected[expert] = (
        2 * cfg.num_local_experts * layers * (len(calls) - fast)
    )
    return expected


@contextlib.contextmanager
def plain_versions(fmt: str):
    """Every kernel the model reaches in ``fmt`` swapped for its plain
    version, for the comparisons only."""
    from vptq_tpu_torch.layers import runtime
    from vptq_tpu_torch.models import llama

    name = FORMAT_KERNEL[fmt]
    with contextlib.ExitStack() as stack:
        stack.enter_context(
            mock.patch.object(runtime, name, kernel_fns(name)[1])
        )
        stack.enter_context(
            mock.patch.object(llama, FLASH, kernel_fns(FLASH)[1])
        )
        if fmt in MOE_KERNELS:
            expert, pairs = MOE_KERNELS[fmt]
            stack.enter_context(mock.patch.dict(
                llama._EXPERT_MATMUL, {fmt: kernel_fns(expert)[1]}
            ))
            stack.enter_context(mock.patch.dict(
                llama._PAIRS_MATMUL, {fmt: kernel_fns(pairs)[1]}
            ))
        yield


def phase_e2e(device, path, fmt: str, vocab: int,
              prompt_lens=(16, 128, 512, 1536), new_tokens=32, max_seq=2048,
              seed=0):
    """from_pretrained(runtime_format=fmt) → one greedy request per prompt
    length; launch counts, logits, a decode step and, for a prompt that
    takes the flash kernel, its prefill checked. Serves whatever ``path``
    holds (dense Llama, Qwen2, Mistral or Mixtral). A dense model in int8
    also holds its longest flash prompt's logits against the plain
    versions (K8 swapped with K1)."""
    from vptq_tpu_torch import AutoModelForCausalLM
    from vptq_tpu_torch.models.llama import forward, init_cache
    from vptq_tpu_torch.serving.generate import _pad_bucket

    fns = {k: kernel_fns(k)[0] for k in ALL_KERNELS}
    cuda = torch.device(device).type == "cuda"
    result = dict(format=fmt)
    t0 = time.perf_counter()
    engine = AutoModelForCausalLM.from_pretrained(
        path, runtime_format=fmt, device=device, max_seq=max_seq
    )
    _sync(device)
    result["load_s"] = time.perf_counter() - t0

    model, gen = engine.model, engine.generator
    cfg = model.cfg
    moe = bool(cfg.num_local_experts)
    buckets = gen.prompt_buckets
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n).tolist() for n in prompt_lens]
    flash = [
        p for p in prompts
        if expected_launches(cfg, fmt, len(p), 1, buckets)[FLASH]
    ]
    on_path = (
        FORMAT_KERNEL[fmt], *(MOE_KERNELS[fmt] if moe else ()),
        *((FLASH,) if flash else ()),
    )
    result["kernels"] = list(on_path)
    result["layers"] = cfg.num_hidden_layers
    if cuda:
        result["weights_gb"] = torch.cuda.memory_allocated(device) / 1e9
        torch.cuda.reset_peak_memory_stats(device)

    requests = []
    launches = dict.fromkeys(on_path, 0)
    for prompt in prompts:
        stamps = []
        for f in fns.values():
            f.launches = 0
        t0 = time.perf_counter()
        out = engine.generate(
            prompt, max_new_tokens=new_tokens,
            stream_callback=lambda _tok: stamps.append(time.perf_counter()),
        )
        _sync(device)
        t_end = time.perf_counter()
        counts = {k: f.launches for k, f in fns.items()}
        expected = expected_launches(
            cfg, fmt, len(prompt), len(out), buckets
        )
        if not cuda:
            expected = dict.fromkeys(expected, 0)
        if counts != expected:
            raise AssertionError(
                f"{fmt}: launches {counts}, expected {expected}"
            )
        if len(out) != new_tokens or not all(0 <= t < vocab for t in out):
            raise AssertionError(f"bad tokens {out}")
        for k in on_path:
            launches[k] += counts[k]
        requests.append(dict(
            prompt=len(prompt), new=len(out),
            launches={k: counts[k] for k in on_path},
            ttft_s=stamps[0] - t0,
            decode_tok_s=(len(out) - 1) / (t_end - stamps[0]),
        ))
        print(f"request {fmt} " + json.dumps(requests[-1]))
    if cuda and not all(launches[k] > 0 for k in on_path):
        raise AssertionError(f"{fmt}: a kernel of the path never ran")
    result["requests"] = requests
    result["launches"] = launches
    if cuda:
        result["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9

    # logits: finite for every prompt; the first prompt's, and those of
    # one decode step after it (a MoE prefill never reaches the pairs
    # kernels), through the kernels and through their plain versions
    def logits_of(prompt, decode=False):
        """Logits of the prompt's last chunk (its real rows), prefilled in
        bucket-padded chunks as ``Generator.generate`` does, and of one
        further token."""
        cache = init_cache(cfg, 1, max_seq, gen.dtype, device)
        with torch.inference_mode():
            for done in range(0, len(prompt), buckets[-1]):
                chunk = prompt[done: done + buckets[-1]]
                tokens = torch.zeros(
                    (1, _pad_bucket(len(chunk), buckets)), dtype=torch.int64
                )
                tokens[0, : len(chunk)] = torch.tensor(chunk)
                logits, _ = forward(
                    model, tokens.to(device), cache, dtype=gen.dtype,
                    fresh_prefill=(done == 0),
                )
                cache.lengths = [done + len(chunk)]
            out = [logits[0, : len(chunk)]]
            if decode:
                step = torch.tensor([prompt[:1]], dtype=torch.int64)
                logits, _ = forward(
                    model, step.to(device), cache, dtype=gen.dtype
                )
                out.append(logits[0])
        return out

    def hold_to_plain(prompt, names):
        got = logits_of(prompt, decode=len(names) > 1)
        with plain_versions(fmt):
            want = logits_of(prompt, decode=len(names) > 1)
        for what, g, w in zip(names, got, want):
            diff = (g - w).abs().max().item()
            scale = w.abs().max().item()
            result[f"{what}_logits_max_abs_diff"] = diff
            result[f"{what}_logits_max_abs"] = scale
            if not (diff <= LOGIT_TOL * scale
                    and bool(torch.isfinite(g).all())):
                raise AssertionError(
                    f"{fmt}: {what} logits differ by {diff} (max {scale})"
                )

    for prompt in prompts:
        if not bool(torch.isfinite(logits_of(prompt)[0]).all()):
            raise AssertionError(
                f"{fmt}: non-finite logits for a {len(prompt)}-token prompt"
            )
    hold_to_plain(prompts[0], ("prefill", "decode"))
    if fmt == "int8" and not moe and flash:
        hold_to_plain(flash[-1], ("long_prefill",))

    if cuda:
        # a decode step never reaches the expert kernels or K8
        in_decode = [
            k for k in on_path if not k.endswith("_expert") and k != FLASH
        ]
        result["decode_step"] = decode_breakdown(
            model, gen, prompts[0], {k: fns[k].trace_tags for k in in_decode}
        )
        if flash:
            in_prefill = [k for k in on_path if not k.endswith("_pairs")]
            result["long_prefill"] = prefill_breakdown(
                model, gen, flash[-1],
                {k: fns[k].trace_tags for k in in_prefill},
            )
    del engine, model
    if cuda:
        torch.cuda.empty_cache()
    return result


def _device_events(prof):
    return [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]


def _kernel_ms(events, tags: dict, what: str, per: int = 1) -> dict:
    """Device ms of the events whose names hold each kernel's words."""
    out = {
        name: sum(
            e.device_time_total for e in events
            if all(tag in e.name for tag in words)
        ) / 1e3 / per
        for name, words in tags.items()
    }
    for name, ms in out.items():
        if not ms > 0:
            raise AssertionError(
                f"no kernel named {tags[name]} in the {what} trace"
            )
    return out


def prefill_breakdown(model, gen, prompt, tags: dict):
    """Wall time of one fresh prefill of ``prompt`` padded into its bucket
    (host clock, synchronized) against the device time of the kernels it
    runs (``torch.profiler`` CUDA activity, the same call run again)."""
    from torch.profiler import ProfilerActivity, profile

    from vptq_tpu_torch.models.llama import forward, init_cache
    from vptq_tpu_torch.serving.generate import _pad_bucket

    device = model.embed_tokens.device
    tokens = torch.zeros(
        (1, _pad_bucket(len(prompt), gen.prompt_buckets)), dtype=torch.int64
    )
    tokens[0, : len(prompt)] = torch.tensor(prompt)
    tokens = tokens.to(device)

    def run():
        cache = init_cache(model.cfg, 1, gen.max_seq, gen.dtype, device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        forward(model, tokens, cache, dtype=gen.dtype, fresh_prefill=True)
        torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        run()
        wall_ms = run()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
    events = _device_events(prof)
    out = dict(
        tokens=tokens.shape[1], wall_ms=wall_ms,
        device_busy_ms=sum(e.device_time_total for e in events) / 1e3,
        kernel_ms=_kernel_ms(events, tags, "prefill"),
    )
    print("long prefill " + json.dumps(out))
    return out


def decode_breakdown(model, gen, prompt, tags: dict, steps=8):
    """Wall time of one batch-1 decode step (host clock, synchronized)
    against the device time of the kernels it runs (``torch.profiler``
    CUDA activity, taken over the same steps run again); ``tags`` maps
    each kernel of the path to the words that pick its CUDA kernels by
    name. The steps read nothing back, so the trace must hold no
    device-to-host copy: a routing decision read on the host would be
    one."""
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
    events = _device_events(prof)
    to_host = [e.name for e in events if "dtoh" in e.name.lower()]
    if to_host:
        raise AssertionError(
            f"{len(to_host)} device-to-host copies in {steps} decode "
            f"steps: {to_host[:3]}"
        )
    busy_ms = sum(e.device_time_total for e in events) / 1e3 / steps
    kernel_ms = _kernel_ms(events, tags, "decode", per=steps)
    out = dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms, kernel_ms=kernel_ms,
        kernels_per_step=len(events) / steps,
        idle_share=1.0 - busy_ms / wall_ms, device_to_host_copies=0,
    )
    print("decode step " + json.dumps(out))
    return out


# what the rows of one kernel, summed, stand for in its record, and the
# one PyTorch call timed beside it
RECORD_OF = {
    "_expert": "one expert's gate_up and down",
    "_pairs": "one layer's gate_up and down",
    FLASH: "one layer's attention at Llama-3.1-8B's heads",
}
LIBRARY_OF = {
    "_expert": "torch.matmul of bf16 x with the one expert's dequantized "
               "bf16 weight: a yardstick that reads bf16 weights",
    "_pairs": "torch.bmm of bf16 x over the dequantized bf16 experts "
              "gathered by the ids (index_select): a yardstick that reads "
              "bf16 weights",
    FLASH: "torch.nn.functional.scaled_dot_product_attention(is_causal=True, "
           "enable_gqa=True) on the same q, k, v",
    BF16: "torch.matmul of the same bf16 x and w",
}


def kernel_records(rows, launches, tokens=(1, 512), pairs=(2, 16),
                   seqs=(1024, 2048)):
    """The contract's per-kernel records: each kernel at decode and at
    prefill (pairs kernels: at two pair counts; K8: at two lengths),
    summed over one layer's linears. ``launches`` maps a kernel to its
    count on the main paths that run it."""
    out = []
    rows = [r for r in rows if r.get("in_record", True)]
    for name in dict.fromkeys(r["kernel"] for r in rows):
        kind = name if name in (FLASH, BF16) else name[name.rfind("_"):]
        points = {"_pairs": pairs, FLASH: seqs}.get(kind, tokens)
        for t in points:
            sel = [r for r in rows if r["kernel"] == name and r["T"] == t]
            bytes_ms = sum(r["bytes"] for r in sel) / PEAK_BYTES_PER_S * 1e3
            ops_ms = sum(r["flops"] for r in sel) / PEAK_BF16_FLOPS * 1e3
            what = RECORD_OF.get(kind, "one layer's 4 linears")
            library = LIBRARY_OF.get(
                kind, "torch.matmul of bf16 x with the dequantized bf16 "
                      "weight: a yardstick that reads bf16 weights"
            )
            out.append({
                "name": f"{name} ({sel[0]['unit']}={t}, {what})",
                "route": "cuda",
                "source": f"vptq_tpu_torch/csrc/{name}.cu",
                "replaces": kernel_fns(name)[0].replaces,
                "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in sel),
                "ms": sum(r["ms"] for r in sel),
                "plain_ms": sum(r["plain_ms"] for r in sel),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": sum(r["library_ms"] for r in sel),
                "library": library + "; the port never calls it",
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
        f"kernel vs plain tolerance: |err| <= {RTOL} * |plain| + "
        f"{ATOL_FRAC} * max|plain|; prefill logits: max|diff| <= "
        f"{LOGIT_TOL} * max|logit|"
    )
    print(
        f"{FLASH} vs plain tolerance: |err| <= {FLASH_TOL} * max|plain|"
    )
    rows = []
    for name in FORMAT_KERNEL.values():
        rows += phase_kernel(name, device, k1_shapes(LLAMA31_8B))
    rows += phase_kernel(
        "w8_matmul", device, k1_shapes(QWEN25_7B), in_record=False
    )
    rows += phase_bf16(device, k1_shapes(LLAMA31_8B))
    rows += phase_flash(device)
    for fmt in MOE_KERNELS:
        rows += phase_moe_kernels(fmt, device, moe_shapes(MIXTRAL_8X7B))
    phase_encoders(device)
    launches = dict.fromkeys(ALL_KERNELS, 0)
    # (label, config, formats, what phase_e2e and the writer get beside)
    runs = (
        ("Llama-3.1-8B", LLAMA31_8B, FORMAT_KERNEL, {}, {}),
        ("Mixtral-8x7B", MIXTRAL_8X7B, MOE_KERNELS, {}, {}),
        ("Qwen2.5-7B", QWEN25_7B, ("int8",), {}, dict(qkv_bias=True)),
        ("Mistral-7B", MISTRAL_7B, ("int8",),
         dict(prompt_lens=(16, 512, 1536, 4608), max_seq=8192), {}),
    )
    for label, cfg, formats, e2e_kwargs, writer_kwargs in runs:
        path, write_s = write_checkpoint(cfg, V8_K65536, **writer_kwargs)
        print(f"checkpoint write {label} "
              f"({cfg['num_hidden_layers']} layers): {write_s:.2f} s")
        try:
            for fmt in formats:
                e2e = phase_e2e(
                    device, path, fmt, cfg["vocab_size"], **e2e_kwargs
                )
                print(f"e2e {label} " + json.dumps(e2e))
                for name, n in e2e["launches"].items():
                    launches[name] += n
        finally:
            shutil.rmtree(path, ignore_errors=True)
    print(json.dumps({"kernels": kernel_records(rows, launches)}))
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
