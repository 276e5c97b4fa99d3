#!/usr/bin/env python3
"""Quickest proof that vptq_tpu_torch runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` and ``nvidia-smi``; exits non-zero
without them, or when any phase fails. Phases:

1. build every CUDA kernel of the port from ``vptq_tpu_torch/csrc`` (K1
   ``w8_matmul``, K2 ``w4_matmul``, K3 ``w2_matmul``, K4 ``w3_matmul``,
   the MoE kernels K6a ``w8_matmul_expert``, K5a ``w8_matmul_pairs``,
   K6b ``w4_matmul_expert``, K5b ``w4_matmul_pairs``, K8
   ``flash_attention``, K7 ``bf16_matmul`` and the probes P1/P2
   ``w4_probe_matmul``, ``w4_i32x8_matmul``, ``w4_raw_probe`` and P3
   ``vq_smallk_matmul``), one ``nvcc`` each, all at once; the
   ``-Xptxas -v`` lines of the prefill tile (``lowbit_tile.cuh``) in K1,
   K2, K3, K4, K6a, K6b and K7, of K8's kernel at each head size and of
   the decode GEMV (``decode_gemv.cuh``) in K1, K2, K3, K4 and K5b, every
   instance of which must show no spill;
2. each of K1-K4 at the four linear shapes of Llama-3.1-8B, on layers its
   format's encoder makes on the card from a random weight (K1 group
   2048, K3 group 64, and 128 beside it), at T=1 (decode), T=128 and
   T=512 (prefill buckets) and T=2048 (the long-prefill chunk; every
   T > 16 through their tile; K1 and K2 also at T=16, the decode GEMV's
   largest instance): the kernel held against its
   plain version on the card, then timed with CUDA events (L2 flushed
   before each launch) beside the plain version and a ``torch.matmul``
   yardstick; K1 also at the four shapes of Qwen2.5-7B (groups 512 and
   1024; intermediate 18944 padded to 19456), T=2048 included;
   K7 at the Llama shapes on a random bf16 weight, at the same T (T > 16
   through the tile's SS form); K8 at Llama-3.1-8B's
   heads (32 over 8 KV heads of 128) on N(0, 1) q, k, v with v a strided
   view into a fused q|k|v row, at S=1024, 2048 and 1100 (no tile divides
   it), at Qwen2.5-7B's heads (28 over 4, GQA group 7) at S=2048, at head
   size 64, at head size 96 (Phi-3-mini's 32 heads; S=1024
   and 1100), and with scores scaled to about +-50, beside
   ``scaled_dot_product_attention`` as its yardstick;
3. the MoE kernels at Mixtral-8x7B's two expert shapes (gate_up
   28672 x 4096, down 4096 x 14336) on stacks of 8 experts that the int8
   and int4 encoders make on the card: K6a / K6b at T=1, 128, 512 and
   2048 (Mixtral's long chunk, through the tile; one expert, the last of
   the stack, whose slab starts 822 MB into gate_up's int8 stack and 411
   MB into the int4 one), K5a / K5b at P=2 (one token's top-2)
   and P=16 (8 tokens' top-2) pairs, K5b also at P=1 and P=128 (64
   tokens' top-2, the most a MoE decode call sends), each against its
   plain version and timed like phase 2, the bound counting the distinct
   experts read; yardsticks ``torch.matmul`` with one expert's
   dequantized bf16 weight and ``torch.bmm`` over the experts' bf16 slabs,
   gathered by the ids before the timed window; then K5b's kernel name
   at each P from one trace, which must be the decode GEMV's
   (``check_decode_routes``);
   then the probes, which no layer calls: every mode of P1 / P2 (prod,
   shift28, fma16, fma16f32, t8, g256; i32x8; s8dot, cvtonly) with K2
   beside them at the probe scripts' four Llama-2-7B decode shapes (T=1),
   P3 at 22016 x 4096 (v 4 and 8, fused and onehot-only, k 256 and k 200,
   where the ids past the codebook must add 0), each against its
   plain version and timed like phase 2 (yardstick ``torch.matmul`` on the
   dequantized or gathered bf16 weight), and the scripts' own checks at
   T=3 (fma16, shift28, P3's ``--check`` and the same with k 200) against
   the plain versions and the scripts' f32 products;
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
   new tokens each, every decode chunk through the generator's CUDA
   graphs (one per live 256-position block count, captured at first use
   and replayed), with every kernel's launch count set to 0 before and
   checked after, replays included (the format's kernel 4 per layer per
   forward call; K8 once per layer for the 1536-token prompt, whose fresh
   2048-token chunk it serves, and 0 for the shorter prompts; the others
   0); the first request's tokens against the eager plain loop
   (``decode_loop``), and 12 steps from 250 cached tokens (across the
   first block boundary) through the graphs and through ``decode_loop``,
   greedy and sampled: tokens identical, logits bit for bit; finite
   logits, and the first prompt's prefill logits held against the same
   model run through the plain version (in int8 the long prompt's too,
   K8 swapped for its plain version with K1); then one eager decode
   step's wall time against the device time of its kernels
   (``torch.profiler``), and the same for a replayed graph step (kernels
   per step, the route of every decode kernel in the trace, no
   device-to-host copy in the chunk, capture seconds, the graphs' pool),
   and for the long prompt's prefill;
6. end to end in int8 and in int4 on one synthetic checkpoint of
   Mixtral-8x7B-v0.1 geometry (full width, 8 experts, top-2; depth as
   ``MIXTRAL_8X7B`` says), the same four requests: per layer and forward
   call 2 launches of K1 / K2 (qkv, o), per layer and decode step 2 of
   K5, per layer and prefill chunk 16 of K6, K8 as above, every other
   kernel 0; the
   first prompt's prefill logits, and one decode step's, through the
   kernels against the plain versions; the profiled decode steps and the
   profiled long prefill must hold no device-to-host copy (the expert ids
   stay on the card);
7. end to end in int8 on one synthetic checkpoint of Qwen2.5-7B geometry
   (a bias on q, k and v; K1's first widths that pad), the same four
   requests, the long prompt's logits against the plain versions;
8. end to end in int8 on one synthetic checkpoint of Mistral-7B-v0.1
   geometry (sliding window 4096) with ``max_seq`` 8192: prompts of 16,
   512, 1536 and 4608 tokens (three chunks; positions from 4096 on lose
   their oldest keys). The window keeps every chunk out of K8, which
   must count 0.

The line before the last is a JSON object with one record per kernel at
T=1 and T=512 (pairs kernels: P=2 and P=16; K8: S=1024 and S=2048; each
probe mode at gate_up T=1, 0 launches on the main path); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import re
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
PEAK_INT8_OPS = 1979e12

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
# a word of the mangled name of the Hopper prefill tile
# (lowbit_tile.cuh), and its instances in each library that holds it: one
# per output type (bf16, f32), and in K3 per scale group (64, 128) too
# (K1's and K6a's groups of 512 to 2048 are a run-time count of stages;
# K7's are the SS form). The kernel phases also time these kernels at a
# long prefill chunk.
TILE_KERNEL = "wg_tile"
TILE_INSTANCES = {
    "w8_matmul": 2, "w4_matmul": 2, "w3_matmul": 2, "w2_matmul": 4,
    "w8_matmul_expert": 2, "w4_matmul_expert": 2, "bf16_matmul": 2,
}
# K8's kernel (fa::flash_wgmma<D>), one instance per head size
FLASH_KERNEL = "flash_wgmma"
FLASH_INSTANCES = {"flash_attention": 3}
# the Hopper decode GEMV of K1–K4 at T <= 16 (decode_gemv.cuh): one
# instance per token tile (N = 8, 16) and output type (bf16, f32), and in
# K3 per scale group (64, 128) too; K5b's pairs run one token a block (N =
# 8), one instance per output type
DECODE_KERNEL = "decode_gemv"
DECODE_INSTANCES = {"w8_matmul": 4, "w4_matmul": 4, "w3_matmul": 4,
                    "w2_matmul": 8, "w4_matmul_pairs": 2}
# the token counts of the kernel phases: decode, two prefill buckets and
# the long-prefill chunk (every T > 16 runs the tile)
TOKENS = (1, 128, 512, 2048)
# the int4-unpack probes P1 / P2 and the small-codebook VQ probe P3: no
# layer calls them (0 launches on every main path); the probe phase does
PROBE_KERNELS = (
    "w4_probe_matmul", "w4_i32x8_matmul", "w4_raw_probe", "vq_smallk_matmul",
)
ALL_KERNELS = (
    *FORMAT_KERNEL.values(), *sum(MOE_KERNELS.values(), ()), FLASH, BF16,
    *PROBE_KERNELS,
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


def ptxas_entries(log: str) -> dict:
    """{mangled kernel name: its ``-Xptxas -v`` lines (spills, registers
    and shared memory)} of one build log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(
            r"(?:Compiling entry function|Function properties for) '?(\w+)",
            line,
        )
        if m:
            name = m.group(1)
            out.setdefault(name, [])
        elif name and ("spill" in line or "registers" in line):
            out[name].append(line.strip())
    return out


def phase_build() -> float:
    """Build every kernel source of the port; returns wall seconds. Each
    library must hold its ``TILE_INSTANCES`` instances of the prefill tile
    (``lowbit_tile.cuh``), its ``FLASH_INSTANCES`` of K8's kernel and its
    ``DECODE_INSTANCES`` of the decode GEMV (``decode_gemv.cuh``), none
    elsewhere, and each must report no spill."""
    from vptq_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build(force=True)
    seconds = time.perf_counter() - t0
    for name, (secs, log) in built.items():
        print(f"built {name} in {secs:.2f} s")
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or "wgmma" in line.lower()):
                print(f"  ptxas: {line.strip()}")
        entries = ptxas_entries(log)
        for word, instances in ((TILE_KERNEL, TILE_INSTANCES),
                                (FLASH_KERNEL, FLASH_INSTANCES),
                                (DECODE_KERNEL, DECODE_INSTANCES)):
            clean = 0
            for entry, lines in entries.items():
                if word not in entry:
                    continue
                print(f"  tile {entry}: " + "; ".join(lines))
                if not any("0 bytes spill stores, 0 bytes spill loads"
                           in line for line in lines):
                    raise AssertionError(f"{name}: the tile {entry} spills")
                clean += 1
            want = instances.get(name, 0)
            if clean != want:
                raise AssertionError(
                    f"{name}: {clean} tile instances ({word}) with 0 spill "
                    f"bytes in the -Xptxas -v log, {want} expected"
                )
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


def make_layer(name, gen, out_f, in_f, device, group=None):
    """The runtime layer that kernel ``name``'s format encoder makes from
    one random f32 (out, in) weight on ``device`` (K1 group from
    ``pick_group``, K3 group 64 unless ``group`` says otherwise, the
    padding the encoders apply)."""
    from vptq_tpu_torch.layers import runtime as rt

    fmt = next(f for f, k in FORMAT_KERNEL.items() if k == name)
    w = torch.randn((out_f, in_f), generator=gen, device=device) * SMOKE_STD
    kwargs = {} if group is None else dict(group=group)
    return getattr(rt, f"_encode_{fmt}")(w, None, **kwargs)


def check_and_time(name, label, call, plain, library, nbytes, flops, device,
                   iters, flush, rtol=RTOL, atol_frac=ATOL_FRAC,
                   peak_ops=PEAK_BF16_FLOPS):
    """One kernel call against its plain version on the same inputs
    (|err| <= rtol * |plain| + atol_frac * max|plain|), then the times of
    both and of the library yardstick beside the bound for ``nbytes``
    moved and ``flops`` done at ``peak_ops`` a second."""
    from vptq_tpu_torch.examples.kernel_bench import time_ms

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
    ops_ms = flops / peak_ops * 1e3
    return dict(
        bytes=nbytes, flops=flops, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        ms=time_ms(call, device, iters, flush),
        plain_ms=time_ms(plain, device, max(iters // 4, 1), flush),
        library_ms=time_ms(library, device, iters, flush),
        max_abs_err=err.max().item(),
    )


def launched_kernels(calls, device) -> list:
    """The name of the one CUDA kernel each call launches, from one
    ``torch.profiler`` session over all of them (many short sessions in
    one process now and then record nothing; a session that lost an event
    is taken again, up to three times)."""
    from torch.profiler import ProfilerActivity, profile

    for call in calls:
        call()
    _sync(device)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for call in calls:
                call()
                _sync(device)
        names = [e.name for e in sorted(_device_events(prof),
                                        key=lambda e: e.time_range.start)]
        if len(names) == len(calls):
            return names
    raise AssertionError(
        f"{len(calls)} calls launched {len(names)} kernels: {names[:4]}")


def phase_kernel(name, device, shapes, tokens=(1, 128, 512), iters=20,
                 seed=0, in_record=True, group=None, routes=None):
    """One kernel at each shape and token count: agreement with its
    plain version, times and bound. ``in_record``: whether the rows go
    into the kernel's record (one model's layer) or stand alone;
    ``group``: K3's scale group, where not its default; ``routes``: a list
    to which each call of up to 16 tokens on the card is appended with its
    row, for :func:`check_decode_routes`."""
    from vptq_tpu_torch.examples.kernel_bench import flush_buffer
    from vptq_tpu_torch.layers.runtime import linear_exact_weight

    fn, ref = kernel_fns(name)
    gen = torch.Generator(device=device).manual_seed(seed)
    flush = flush_buffer(device)
    rows = []
    for shape, out_f, in_f in shapes:
        layer = make_layer(name, gen, out_f, in_f, device, group)
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
            if (routes is not None and t <= 16
                    and torch.device(device).type == "cuda"):
                routes.append((rows[-1], lambda x=x, a=args: fn(x, *a)))
        del layer, args, w_bf16
    return rows


def check_decode_routes(routes, device) -> None:
    """The CUDA kernel each call of ``routes`` (phase_kernel's, up to 16
    tokens, and phase_moe_kernels' K5b calls) launches, from one trace: K2,
    K3 and K5b run the Hopper decode GEMV at every shape and pair count
    the kernel phases time; K1 and K4 run it where their wrappers' rule
    routes them (``takes_decode_gemv`` of ``ops/w8_matmul.py``,
    ``ops/w3_matmul.py``) and the older GEMV elsewhere. The names are
    picked by the wrappers' ``trace_tags`` (the decode GEMV's family:
    ``decode_gemv``, the format and the selection, ``Whole`` or
    ``Pairs``)."""
    names = launched_kernels([call for _, call in routes], device)
    for (r, _), kernel in zip(routes, names):
        print(f"{r['kernel']} {r['shape']} {r['unit']}={r['T']} "
              f"g{r['group']} runs {kernel}")
        fn = kernel_fns(r["kernel"])[0]
        family = next(t for t in tag_sets(fn.trace_tags)
                      if "decode_gemv" in t)
        rule = getattr(importlib.import_module(
            f"vptq_tpu_torch.ops.{r['kernel']}"), "takes_decode_gemv", None)
        want = rule is None or rule(r["T"], r["out"], r["in_p"])
        if picks((family,), kernel) != want:
            raise AssertionError(
                f"{r['kernel']} {r['shape']} {r['unit']}={r['T']} ran "
                f"{kernel}; the decode GEMV expected: {want}")
    print(f"decode routes: {len(routes)} calls, each on its route")


def phase_bf16(device, shapes, tokens=TOKENS, iters=20, seed=0):
    """K7 at each shape and token count on a random bf16 weight against
    its plain version; the yardstick is ``torch.matmul`` on the same
    tensors."""
    from vptq_tpu_torch.examples.kernel_bench import flush_buffer

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
    # Qwen2.5-7B's heads: 28 over 4 KV heads, GQA group 7
    ("qwen2.5-7b heads", 1, 2048, 28, 4, 128, 1.0, False),
    ("head size 64, two sequences", 2, 1100, 8, 2, 64, 1.0, False),
    # Phi-3-mini's heads: 32 of 96, no grouping
    ("head size 96", 1, 1024, 32, 32, 96, 1.0, False),
    ("head size 96", 1, 1100, 32, 32, 96, 1.0, False),
    # q.k / sqrt(D) ~ N(0, 12^2): scores reach about +-50
    ("scores to +-50", 1, 1024, 32, 8, 128, 12.0 ** 0.5, False),
)


def phase_flash(device, cases=FLASH_CASES, iters=20, seed=0):
    """K8 on N(0, 1) q, k, v in bf16, v a strided view into a fused
    q|k|v row as the model gives it, against its plain version; the
    yardstick is ``scaled_dot_product_attention`` on the same tensors,
    which the port never calls."""
    import torch.nn.functional as F

    from vptq_tpu_torch.examples.kernel_bench import flush_buffer

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
                      pairs=(2, 16), top_k=2, iters=20, seed=0, routes=None):
    """The expert (K6) and pairs (K5) kernels of ``fmt`` at each shape, on
    a stack of ``n_experts`` that the format's encoder makes on ``device``:
    the expert kernel on the stack's last expert at each token count, the
    pairs kernel on the first P of the top-``top_k`` ids of ⌈P / top_k⌉
    tokens (distinct per token, drawn from ``seed``). ``routes``: a list
    to which each pairs call on the card of a kernel with a decode-GEMV
    family is appended with its row, for :func:`check_decode_routes`."""
    from vptq_tpu_torch.examples.kernel_bench import flush_buffer
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
                for _ in range(-(-n_pairs // top_k))
            ])[:n_pairs]
            distinct = len(set(ids.tolist()))
            ids = ids.to(device=device, dtype=torch.int32)
            x = torch.randn(
                (n_pairs, in_p), generator=gen, device=device
            ).to(torch.bfloat16)
            # the yardstick's operands: the P experts' bf16 slabs gathered
            # here, outside the timed window, so that one torch.bmm is timed
            x3 = x[:, None, :]
            w_pairs = w_bf16.index_select(0, ids.to(torch.int64)).transpose(
                1, 2)
            rows.append(dict(
                kernel=p_name, shape=shape, unit="P", T=n_pairs, out=out_f,
                in_p=in_p, group=group, experts=n_experts, distinct=distinct,
                **check_and_time(
                    p_name, f"{shape} P={n_pairs}",
                    lambda: p_fn(x, wq, scales, ids),
                    lambda: p_ref(x, wq, scales, ids),
                    lambda: torch.bmm(x3, w_pairs),
                    # each distinct expert's slab counted once, however
                    # many pairs pick it
                    n_pairs * (in_p * 2 + 4 + out_f * 2) + distinct * slab,
                    2 * n_pairs * out_f * in_p, device, iters, flush,
                ),
            ))
            print(f"{p_name} " + json.dumps(rows[-1]))
            del x3, w_pairs
            if (routes is not None and torch.device(device).type == "cuda"
                    and any(DECODE_KERNEL in t
                            for t in tag_sets(p_fn.trace_tags))):
                routes.append((rows[-1], lambda x=x, w=wq, s=scales, i=ids:
                               p_fn(x, w, s, i)))
        del wq, scales, w_bf16, w_last
    return rows


# the decode shapes of one Llama-2-7B layer as the probe scripts hard-code
# them (examples/w4_wall_candidates.py, w4_unpack_ablation.py): (name, out,
# in); P3 runs the first of them (examples/vq_smallk_probe.py)
PROBE_SHAPES = (
    ("gate_up", 22016, 4096),
    ("down", 4096, 12288),
    ("qkv", 12288, 4096),
    ("o", 4096, 4096),
)


def phase_probes(device, shapes=PROBE_SHAPES, iters=20, seed=0,
                 cases=True):
    """P1, P2 and P3 at decode (T = 1) on random codes made on ``device``:
    every mode of ``w4_probe_matmul`` (x in f32 where the mode reads it so),
    ``w4_i32x8_matmul``, both ``w4_raw_probe`` modes and K2 ``w4_matmul``
    beside them at each shape; ``vq_smallk_matmul`` at the first shape, v 4
    and 8, fused and onehot-only, k 256 (the records) and k 200 (ids past
    the codebook, which must add 0). Each against its plain version and
    timed beside its bound; the yardstick is ``torch.matmul`` on the
    dequantized (P3: gathered) bf16 weight of the same function, which the
    port never calls. ``cases``: also the scripts' own checks at T = 3
    (:func:`probe_cases`)."""
    from vptq_tpu_torch.examples.kernel_bench import flush_buffer
    from vptq_tpu_torch.ops.packing import unpack_int4
    from vptq_tpu_torch.ops.vq_smallk_matmul import vq_smallk_weight
    from vptq_tpu_torch.ops.w4_i32x8_matmul import i32x8_levels
    from vptq_tpu_torch.ops.w4_probe_matmul import F32_X_MODES, W4_PROBE_MODES

    gen = torch.Generator(device=device).manual_seed(seed)
    flush = flush_buffer(device)
    bf16 = torch.bfloat16
    rows = []

    def add(name, mode, shape, x, out_f, in_f, call, plain, library, flops,
            in_record, reads, extra=(), y_size=2, **kw):
        """One row; bytes: the tensors in ``reads``, each read once, and the
        output of ``y_size`` bytes a value, written once."""
        fn = kernel_fns(name)[0]
        nbytes = sum(t.numel() * t.element_size() for t in reads)
        nbytes += x.shape[0] * out_f * y_size
        rows.append(dict(
            kernel=name, mode=mode, shape=shape, unit="T", T=x.shape[0],
            out=out_f, in_p=in_f, in_record=in_record,
            replaces=getattr(fn, "bodies", {}).get(mode.split()[-1],
                                                   fn.replaces),
            **dict(extra),
            **check_and_time(name, f"{mode} {shape} T={x.shape[0]}", call,
                             plain, library, nbytes, flops, device, iters,
                             flush, **kw),
        ))
        print(f"{name} " + json.dumps(rows[-1]))

    for shape, out_f, in_f in shapes:
        first = shape == shapes[0][0]
        wq8 = torch.randint(-120, 120, (out_f, in_f // 2), generator=gen,
                            device=device, dtype=torch.int8)
        wq32 = torch.randint(-2 ** 31, 2 ** 31 - 1, (out_f, in_f // 8),
                             generator=gen, device=device, dtype=torch.int32)
        scales = (0.005 * (1 + torch.rand((in_f // 128, out_f), generator=gen,
                                          device=device))).to(bf16)
        x = torch.randn((1, in_f), generator=gen, device=device).to(bf16)
        flops = 2 * out_f * in_f
        w = _dequant(unpack_int4(wq8), scales)
        for mode in (*W4_PROBE_MODES, "w4_matmul"):
            xm = x.float() if mode in F32_X_MODES else x
            name = "w4_matmul" if mode == "w4_matmul" else "w4_probe_matmul"
            fn, ref = kernel_fns(name)
            args = (xm, wq8, scales) + ((mode,) if name != "w4_matmul" else ())
            # g256 reads every other scale row
            s_read = scales[::2] if mode == "g256" else scales
            add(name, mode, shape, xm, out_f, in_f,
                lambda f=fn, a=args: f(*a, out_dtype=bf16),
                lambda f=ref, a=args: f(*a, out_dtype=bf16),
                lambda: torch.matmul(x, w.t()), flops,
                first and name != "w4_matmul", (xm, wq8, s_read))
        fn, ref = kernel_fns("w4_i32x8_matmul")
        w = _dequant(i32x8_levels(wq32), scales)
        add("w4_i32x8_matmul", "i32x8", shape, x, out_f, in_f,
            lambda: fn(x, wq32, scales), lambda: ref(x, wq32, scales),
            lambda: torch.matmul(x, w.t()), flops, first, (x, wq32, scales))
        fn, ref = kernel_fns("w4_raw_probe")
        # the raw bytes times scale row 0, against columns [0, in/2) of x
        w = (wq8.to(torch.float32) * scales[0].to(torch.float32)[:, None]
             ).to(bf16)
        xh = x[:, : in_f // 2].contiguous()
        for mode, xm in (("s8dot", xh.to(torch.int8)), ("cvtonly", xh)):
            add("w4_raw_probe", mode, shape, xm, out_f, in_f,
                lambda a=xm, m=mode: fn(a, wq8, scales, m, out_dtype=bf16),
                lambda a=xm, m=mode: ref(a, wq8, scales, m, out_dtype=bf16),
                lambda: torch.matmul(xh, w.t()), flops // 2, first,
                (xm, wq8, scales[0]),
                peak_ops=PEAK_INT8_OPS if mode == "s8dot" else PEAK_BF16_FLOPS)
        del w, wq8, wq32, scales

    fn, ref = kernel_fns("vq_smallk_matmul")
    shape, out_f, in_f = shapes[0]
    x = torch.randn((1, in_f), generator=gen, device=device).to(bf16)
    for v in (4, 8):
        ids = torch.randint(0, 256, (out_f, in_f // v), generator=gen,
                            device=device, dtype=torch.uint8)
        cb256 = (torch.randn((256, v), generator=gen, device=device) * 0.02
                 ).to(bf16)
        # k 256: the record; k 200: the ids >= k, about a fifth, must add 0
        for k in (256, 200):
            cb = cb256[:k].contiguous()
            for onehot in (False, True):
                if onehot:
                    # the same function in one call: the first column of
                    # each v-vector of x against the ids that hit the codebook
                    xl = x[:, ::v].contiguous()
                    w = (ids.to(torch.int64) < k).to(bf16)
                    reads, flops = (xl, ids), 2 * out_f * in_f // v
                else:
                    xl, w = x, vq_smallk_weight(ids, cb).to(bf16)
                    reads, flops = (x, ids, cb), 2 * out_f * in_f
                add("vq_smallk_matmul",
                    f"v{v} {'' if k == 256 else f'k{k} '}"
                    f"{'onehot_only' if onehot else 'fused'}", shape, x,
                    out_f, in_f,
                    lambda i=ids, c=cb, vv=v, oh=onehot: fn(x, i, c, vv, oh),
                    lambda i=ids, c=cb, vv=v, oh=onehot: ref(x, i, c, vv, oh),
                    lambda a=xl, b=w: torch.matmul(a, b.t()), flops,
                    k == 256, reads)
                del w
        del ids, cb, cb256
    if cases:
        probe_cases(device, add)
    return rows


def _dequant(levels, scales, group=128):
    """bf16 (out, in) weight of exact levels and (in/group, out) scales: the
    probe yardsticks' operand."""
    s = scales.to(torch.float32).t().repeat_interleave(group, dim=1)
    return (levels.to(torch.float32) * s).to(torch.bfloat16)


# the probe scripts' fma16 and shift28 checks print max |err| / max |want|
# against the f32 product of f32 x and scales; with both rounded to bf16
# that is about 2^-8
SCRIPT_REL_TOL = 2e-2


def probe_cases(device, add):
    """The probe scripts' own correctness cases at T = 3 through ``add``
    (phase_probes'), each mode held against its plain version and its
    script's f32 product: fma16 and fma16f32 on ``check_fma16_exact``'s
    bytes, prod / shift28 / t8 on the shift28 check's and g256 there against
    its plain version only (the script checks shift28), within
    ``SCRIPT_REL_TOL``; P3 on ``--check`` and on the same with k 200 (ids
    past the codebook) in f32, within the script's limit 0.05·max|want| +
    0.05. The yardstick is ``torch.matmul`` on the script's f32 weight in
    bf16."""
    from vptq_tpu_torch.examples import vq_smallk_probe as vq
    from vptq_tpu_torch.examples import w4_unpack_ablation as ua
    from vptq_tpu_torch.examples import w4_wall_candidates as wc
    from vptq_tpu_torch.ops.packing import pack_int4

    bf16, f32 = torch.bfloat16, torch.float32

    def on(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return t if dtype is None else t.to(dtype)

    def run(name, mode, label, xs, w_ref, args, want, limit, f32_x=False,
            out_dtype=bf16):
        fn, ref = kernel_fns(name)
        x = on(xs, f32 if f32_x else bf16)
        got = fn(x, *args, out_dtype=out_dtype).float().cpu().numpy()
        err = float(np.abs(got - want).max())
        if limit is not None and not err <= limit:
            raise AssertionError(
                f"{name} {mode} {label}: max |err| {err} against the "
                f"script's f32 product, over {limit}")
        w, xb = on(w_ref, bf16), on(xs, bf16)
        add(name, mode, label, x, w.shape[0], w.shape[1],
            lambda: fn(x, *args, out_dtype=out_dtype),
            lambda: ref(x, *args, out_dtype=out_dtype),
            lambda: torch.matmul(xb, w.t()), 2 * x.shape[0] * w.numel(),
            False, (x, *(a for a in args if isinstance(a, torch.Tensor))),
            extra=dict(script_err=err, script_limit=limit),
            y_size=torch.finfo(out_dtype).bits // 8,
            **(dict(rtol=0.0, atol_frac=1e-5) if out_dtype == f32 else {}))

    xs, b, s, w_ref = wc.fma16_case()
    want = xs @ w_ref
    rel = SCRIPT_REL_TOL * float(np.abs(want).max())
    for mode in ("fma16", "fma16f32"):
        run("w4_probe_matmul", mode, "check_fma16_exact", xs, w_ref.T,
            (on(b), on(s, bf16), mode), want, rel, f32_x=mode == "fma16f32")
    xs, q, s, w_ref = ua.shift28_case()
    want = xs @ w_ref
    rel = SCRIPT_REL_TOL * float(np.abs(want).max())
    wq = pack_int4(torch.from_numpy(q)).to(device)
    for mode in ("prod", "shift28", "t8", "g256"):
        run("w4_probe_matmul", mode, "shift28 check", xs, w_ref.T,
            (wq, on(s, bf16), mode), want, None if mode == "g256" else rel,
            f32_x=mode == "t8")
    for k in (256, 200):
        xs, ids, cb, w = vq.check_case(k)
        want = xs @ w.T
        run("vq_smallk_matmul", "v8 fused", f"--check k={k}", xs, w,
            (on(ids), on(cb), 8, False), want,
            0.05 * float(np.abs(want).max()) + 0.05, f32_x=True,
            out_dtype=f32)


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
                      buckets, dtype=torch.bfloat16) -> dict:
    """Launches of every kernel in one request on the card: the prompt in
    bucket-padded chunks, then one forward call per further token. The
    first chunk, when it holds 1024 tokens or more, the model has no
    sliding window and K8 is built for ``dtype`` and the head size, goes
    through K8 once per layer. A MoE block sends a call of at most 64
    tokens through the pairs kernel twice, and a longer one through the
    expert kernel 2·E times. K7 is on no path."""
    from vptq_tpu_torch.models.llama import _MOE_FAST_MAX_TOKENS, takes_flash
    from vptq_tpu_torch.serving.generate import _pad_bucket

    layers = cfg.num_hidden_layers
    calls = [
        _pad_bucket(min(buckets[-1], prompt_len - done), buckets)
        for done in range(0, prompt_len, buckets[-1])
    ] + [1] * (new_tokens - 1)
    expected = dict.fromkeys(ALL_KERNELS, 0)
    if takes_flash(cfg, calls[0], dtype):
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


def prefill(model, gen, prompt):
    """``prompt`` into the generator's persistent cache in bucket-padded
    chunks, as ``Generator.generate`` does (its lengths rewound to the
    true length after each chunk); returns the last chunk's real rows'
    logits."""
    from vptq_tpu_torch.models.llama import forward
    from vptq_tpu_torch.serving.generate import _pad_bucket

    buckets, cache = gen.prompt_buckets, gen.cache
    device = model.embed_tokens.device
    cache.reset(0)
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
        cache.reset(done + len(chunk))
    return logits[0, : len(chunk)]


def eager_tokens(model, gen, prompt, new_tokens):
    """The greedy tokens of one request through the eager plain loop
    (``decode_loop``), on the generator's own cache."""
    from vptq_tpu_torch.serving.generate import decode_loop

    with torch.inference_mode():
        first = torch.argmax(prefill(model, gen, prompt)[-1:], dim=-1)
        toks, _ = decode_loop(
            model, first, gen.cache, None, 0.0, steps=new_tokens - 1,
            dtype=gen.dtype,
        )
    return [int(first[0]), *toks[:, 0].tolist()]


def graph_against_eager(model, gen, prompt, steps, temperature=0.0, seed=5):
    """``steps`` decode steps after ``prompt`` through the generator's
    CUDA graphs and then again through ``decode_loop`` from the same
    cache (its lengths rewound): tokens identical and every step's logits
    bit-equal, or it fails. Returns the block counts the steps ran."""
    from vptq_tpu_torch.serving.generate import decode_loop, decode_plan

    graphs = gen.graphs
    with torch.inference_mode():
        first = torch.argmax(prefill(model, gen, prompt)[-1:], dim=-1)
        start = gen.cache.max_len
        graphs.begin(first, temperature, seed)
        got = [graphs.step().clone() for _ in range(steps)]
        got_toks = graphs.tokens[:steps, 0].tolist()
        gen.cache.reset(start)
        want = []
        toks, _ = decode_loop(
            model, first, gen.cache,
            torch.Generator(device=first.device).manual_seed(seed),
            temperature, steps=steps, dtype=gen.dtype, logits=want,
        )
    if got_toks != toks[:, 0].tolist():
        raise AssertionError(
            f"graph tokens {got_toks} != eager {toks[:, 0].tolist()}")
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            raise AssertionError(
                f"step {i}: graph logits differ from eager by "
                f"{(g - w).abs().max().item()}")
    return sorted(set(decode_plan(start, steps, gen.max_seq)))


def phase_e2e(device, path, fmt: str, vocab: int,
              prompt_lens=(16, 128, 512, 1536), new_tokens=32, max_seq=2048,
              seed=0):
    """from_pretrained(runtime_format=fmt) → one greedy request per prompt
    length, each decode chunk through the generator's CUDA graphs on the
    card; launch counts (replays included), logits, a decode step and,
    for a prompt that takes the flash kernel, its prefill checked. On the
    card the graphs are held to the eager plain loop: the first request's
    tokens, and a run that crosses a 256-position block boundary, greedy
    and sampled, logits bit for bit. Serves whatever ``path`` holds
    (dense Llama, Qwen2, Mistral or Mixtral). A dense model in int8 also
    holds its longest flash prompt's logits against the plain versions
    (K8 swapped with K1)."""
    from vptq_tpu_torch import AutoModelForCausalLM
    from vptq_tpu_torch.models.llama import forward

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
        if expected_launches(cfg, fmt, len(p), 1, buckets, gen.dtype)[FLASH]
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
    if cuda != (gen.graphs is not None):
        raise AssertionError(f"{fmt}: the card decodes through graphs only")

    requests, outs = [], []
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
            cfg, fmt, len(prompt), len(out), buckets, gen.dtype
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
        outs.append(out)
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
        # the graphs against the eager loop: the first request's tokens,
        # then 12 steps from 250 cached tokens (blocks 1 and 2), greedy
        # and sampled, logits bit for bit
        if eager_tokens(model, gen, prompts[0], new_tokens) != outs[0]:
            raise AssertionError(f"{fmt}: graph tokens differ from eager")
        boundary = rng.integers(0, vocab, 250).tolist()
        result["graph_vs_eager"] = dict(
            tokens_identical=True,
            logits_bit_equal_blocks=graph_against_eager(
                model, gen, boundary, 12),
            sampled_bit_equal_blocks=graph_against_eager(
                model, gen, boundary, 12, temperature=0.8),
        )
        print(f"graph vs eager {fmt} " + json.dumps(result["graph_vs_eager"]))

    # logits: finite for every prompt; the first prompt's, and those of
    # one decode step after it (a MoE prefill never reaches the pairs
    # kernels), through the kernels and through their plain versions
    def logits_of(prompt, decode=False):
        """Logits of the prompt's last chunk (its real rows), prefilled as
        ``Generator.generate`` does, and of one further token."""
        with torch.inference_mode():
            out = [prefill(model, gen, prompt)]
            if decode:
                step = torch.tensor([prompt[:1]], dtype=torch.int64)
                logits, _ = forward(
                    model, step.to(device), gen.cache, dtype=gen.dtype
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
        tags = {k: fns[k].trace_tags for k in in_decode}
        result["decode_step"] = decode_breakdown(
            model, gen, prompts[0], tags
        )
        result["graph_step"] = graph_breakdown(
            model, gen, prompts[0], tags, fmt
        )
        if flash:
            in_prefill = [k for k in on_path if not k.endswith("_pairs")]
            result["long_prefill"] = prefill_breakdown(
                model, gen, flash[-1],
                {k: fns[k].trace_tags for k in in_prefill},
            )
    del engine, model, gen
    if cuda:
        torch.cuda.empty_cache()
    return result


def _device_events(prof):
    return [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]


def tag_sets(trace_tags: tuple) -> tuple:
    """A wrapper's ``trace_tags`` as tuples of words: a kernel whose name
    holds every word of one of them is the wrapper's. A wrapper whose
    CUDA kernels share no words beyond another wrapper's gives one tuple
    per family of them."""
    return trace_tags if isinstance(trace_tags[0], tuple) else (trace_tags,)


def picks(trace_tags: tuple, kernel_name: str) -> bool:
    """Whether a wrapper's ``trace_tags`` pick a CUDA kernel's (demangled)
    name out of a trace."""
    return any(all(tag in kernel_name for tag in words)
               for words in tag_sets(trace_tags))


def _kernel_ms(events, tags: dict, what: str, per: int = 1) -> dict:
    """Device ms of the events whose names hold each kernel's words; an
    event that two kernels' words pick fails it (each CUDA kernel belongs
    to one family of one kernel)."""
    for e in events:
        owners = [n for n, t in tags.items() if picks(t, e.name)]
        if len(owners) > 1:
            raise AssertionError(
                f"{e.name} in the {what} trace is picked by {owners}")
    out = {
        name: sum(
            e.device_time_total for e in events if picks(trace_tags, e.name)
        ) / 1e3 / per
        for name, trace_tags in tags.items()
    }
    for name, ms in out.items():
        if not ms > 0:
            raise AssertionError(
                f"no kernel named {tags[name]} in the {what} trace"
            )
    return out


def _device_to_host(events, what: str) -> int:
    """The device-to-host copies of a trace: there must be none, since a
    routing id or a length read on the host would be one."""
    to_host = [e.name for e in events if "dtoh" in e.name.lower()]
    if to_host:
        raise AssertionError(
            f"{len(to_host)} device-to-host copies in {what}: {to_host[:3]}"
        )
    return len(to_host)


def prefill_breakdown(model, gen, prompt, tags: dict):
    """Wall time of one fresh prefill of ``prompt`` padded into its bucket
    (host clock, synchronized) against the device time of the kernels it
    runs (``torch.profiler`` CUDA activity, the same call run again). The
    prefill reads nothing back: the trace must hold no device-to-host
    copy (a MoE layer's expert ids stay on the card)."""
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
        device_to_host_copies=_device_to_host(events, "a long prefill"),
    )
    print("long prefill " + json.dumps(out))
    return out


def decode_breakdown(model, gen, prompt, tags: dict, steps=8):
    """Wall time of one batch-1 eager decode step (host clock,
    synchronized) against the device time of the kernels it runs
    (``torch.profiler`` CUDA activity, taken over the same steps run
    again); ``tags`` maps each kernel of the path to the words that pick
    its CUDA kernels by name. The steps read nothing back, so the trace
    must hold no device-to-host copy: a routing decision read on the host
    would be one."""
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
    to_host = _device_to_host(events, f"{steps} decode steps")
    busy_ms = sum(e.device_time_total for e in events) / 1e3 / steps
    kernel_ms = _kernel_ms(events, tags, "decode", per=steps)
    out = dict(
        wall_ms=wall_ms, device_busy_ms=busy_ms, kernel_ms=kernel_ms,
        kernels_per_step=len(events) / steps,
        idle_share=1.0 - busy_ms / wall_ms, device_to_host_copies=to_host,
    )
    print("decode step " + json.dumps(out))
    return out


def decode_calls(model, fmt: str) -> list:
    """(kernel, out, in_p) of every kernel call of one decode step, in
    order: each block's linears (qkv, o, gate_up, down, or their unfused
    parts), and a MoE block's two pairs calls (gate_up, down)."""
    from vptq_tpu_torch.models.llama import MoeMlp

    def call(lin):
        in_p = getattr(lin, "in_padded", None) or lin.wq.shape[1]
        return FORMAT_KERNEL[fmt], lin.out_features, in_p

    out = []
    for block in model.blocks:
        attn, mlp = block.attn, block.mlp
        lins = ([attn.qkv_proj] if attn.qkv_proj is not None
                else [attn.q_proj, attn.k_proj, attn.v_proj]) + [attn.o_proj]
        if isinstance(mlp, MoeMlp):
            st = mlp.stacked
            pairs = MOE_KERNELS[fmt][1]
            out += [call(lin) for lin in lins] + [
                (pairs, st.gate_up_wq.shape[1], None),
                (pairs, st.down_wq.shape[1], None),
            ]
            continue
        lins += ([mlp.gate_up_proj] if mlp.gate_up_proj is not None
                 else [mlp.gate_proj, mlp.up_proj]) + [mlp.down_proj]
        out += [call(lin) for lin in lins]
    return out


def step_routes(events, model, fmt: str, what: str) -> dict:
    """The route check of one decode step's trace: each kernel's CUDA
    kernels fall in the families its wrapper routes one token to (K2,
    K3, K5b: the decode GEMV, ``decode_gemv`` with ``Whole`` or
    ``Pairs``; K1 and K4: their ``takes_decode_gemv`` per linear; the
    rest their only family), every such family present and no other.
    Returns {kernel: families seen}."""
    want = {}
    for kernel, out_f, in_p in decode_calls(model, fmt):
        families = tag_sets(kernel_fns(kernel)[0].trace_tags)
        decode = [t for t in families if "decode_gemv" in t]
        rule = getattr(importlib.import_module(
            f"vptq_tpu_torch.ops.{kernel}"), "takes_decode_gemv", None)
        if decode and (rule is None or rule(1, out_f, in_p)):
            picked = decode[0]
        else:
            picked = next(t for t in families if "decode_gemv" not in t)
        want.setdefault(kernel, set()).add(picked)
    seen = {}
    for kernel in want:
        # the decode GEMV's names also hold the words of lowbit.cuh's
        # family (its Planes, ScalesOf): its own family comes first
        families = sorted(tag_sets(kernel_fns(kernel)[0].trace_tags),
                          key=lambda t: "decode_gemv" not in t)
        for e in events:
            fam = next((t for t in families if picks((t,), e.name)), None)
            if fam is not None:
                seen.setdefault(kernel, set()).add(fam)
    if seen != want:
        raise AssertionError(
            f"{fmt} {what}: kernel families {seen}, routes say {want}")
    return {k: sorted(" ".join(t) for t in v) for k, v in seen.items()}


def kernel_families(events, steps: int, top: int = 12) -> dict:
    """The ``top`` kernel families of a trace by launches: {family:
    [launches a step, device ms a step]}, a family being a kernel's name
    without its namespace, template arguments and parameters."""
    fams = {}
    for e in events:
        name = re.sub(r"<.*", "", e.name.replace("(anonymous namespace)", ""))
        name = name.split("(")[0].split("::")[-1].replace("void ", "").strip()
        n, us = fams.get(name, (0, 0.0))
        fams[name] = (n + 1, us + e.device_time_total)
    ranked = sorted(fams.items(), key=lambda kv: -kv[1][0])[:top]
    return {k: [n / steps, us / 1e3 / steps] for k, (n, us) in ranked}


def graph_breakdown(model, gen, prompt, tags: dict, fmt: str, steps=8):
    """The graphed decode step (``gen.graphs``, greedy, from ``prompt``):
    wall time (host clock over ``steps`` replays, synchronized) against
    the device time of the kernels the replays run (``torch.profiler``
    over the same steps run again), the kernels per step, the routes
    (:func:`step_routes`: CUPTI records the kernels of a replay), no
    device-to-host copy inside the chunk, the seconds of each capture so
    far and the bytes of the graphs' pool."""
    from torch.profiler import ProfilerActivity, profile

    device = model.embed_tokens.device
    graphs = gen.graphs

    def run(n):
        for _ in range(n):
            graphs.step()
        torch.cuda.synchronize(device)

    with torch.inference_mode():
        first = torch.argmax(prefill(model, gen, prompt)[-1:], dim=-1)
        graphs.begin(first, 0.0, 0)
        run(2)  # captured at the first request already: replays
        t0 = time.perf_counter()
        run(steps)
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(steps)
    events = _device_events(prof)
    busy_ms = sum(e.device_time_total for e in events) / 1e3 / steps
    span_ms = (max(e.time_range.end for e in events)
               - min(e.time_range.start for e in events)) / 1e3 / steps
    out = dict(
        wall_ms=wall_ms, tok_s=1e3 / wall_ms, device_busy_ms=busy_ms,
        idle_share=1.0 - busy_ms / wall_ms, trace_span_ms=span_ms,
        trace_idle_share=1.0 - busy_ms / span_ms,
        kernels_per_step=len(events) / steps,
        families=kernel_families(events, steps),
        kernel_ms=_kernel_ms(events, tags, "graph decode", per=steps),
        device_to_host_copies=_device_to_host(
            events, f"{steps} replayed decode steps"),
        routes=step_routes(events, model, fmt, "replayed step"),
        capture_s={f"{n // 256} blocks{' sampled' if s else ''}": t
                   for (n, s), t in graphs.capture_s.items()},
        graphs=len(graphs.captured),
        pool_mb=graphs.pool_bytes() / 1e6,
    )
    print("graph decode step " + json.dumps(out))
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
    "_pairs": "torch.bmm of bf16 x over the P pairs' dequantized bf16 "
              "expert slabs, gathered by the ids (index_select) before the "
              "timed window: a yardstick that reads bf16 weights",
    FLASH: "torch.nn.functional.scaled_dot_product_attention(is_causal=True, "
           "enable_gqa=True) on the same q, k, v",
    BF16: "torch.matmul of the same bf16 x and w",
}
PROBE_LIBRARY = (
    "torch.matmul of bf16 x with the bf16 weight of the same function (the "
    "dequantized levels; P3: the gathered codebook vectors; onehot-only: x's "
    "first column of each vector against the ids' hits): a yardstick that "
    "reads bf16 weights"
)


def kernel_records(rows, launches, tokens=(1, 512), pairs=(2, 16),
                   seqs=(1024, 2048)):
    """The contract's per-kernel records: each kernel at decode and at
    prefill (pairs kernels: at two pair counts; K8: at two lengths),
    summed over one layer's linears; each probe (rows with a mode) once
    per mode at its record row. ``launches`` maps a kernel to its count on
    the main paths that run it."""
    out = []
    rows = [r for r in rows if r.get("in_record", True)]
    probes = [r for r in rows if "mode" in r]
    rows = [r for r in rows if "mode" not in r]
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
    for r in probes:
        out.append({
            "name": f"{r['kernel']} {r['mode']} (T={r['T']}, {r['shape']} "
                    f"{r['out']}x{r['in_p']}: the probe scripts' Llama-2-7B "
                    "shape)",
            "route": "cuda",
            "source": f"vptq_tpu_torch/csrc/{r['kernel']}.cu",
            "replaces": r["replaces"],
            "launches": launches[r["kernel"]],
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
            "library": PROBE_LIBRARY + "; the port never calls it",
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
    rows, routes = [], []
    for name in FORMAT_KERNEL.values():
        rows += phase_kernel(name, device, k1_shapes(LLAMA31_8B), TOKENS,
                             routes=routes)
    # K1–K4 at the decode GEMV's largest instance (N = 16)
    for name in FORMAT_KERNEL.values():
        rows += phase_kernel(
            name, device, k1_shapes(LLAMA31_8B), (16,), in_record=False,
            routes=routes,
        )
    # K1 at 8 tokens: its decode GEMV's N = 8 instance (w8_gemv takes T = 1)
    rows += phase_kernel(
        "w8_matmul", device, k1_shapes(LLAMA31_8B), (8,), in_record=False,
        routes=routes,
    )
    # K3 at its other scale group (128: the tile unsplit), T = 16 too
    rows += phase_kernel(
        "w2_matmul", device, k1_shapes(LLAMA31_8B), (1, 16, *TOKENS[1:]),
        in_record=False, group=128, routes=routes,
    )
    # K1 at Qwen2.5-7B's groups 512 (in 3584) and 1024 (in 19456)
    rows += phase_kernel(
        "w8_matmul", device, k1_shapes(QWEN25_7B), TOKENS, in_record=False,
        routes=routes,
    )
    rows += phase_bf16(device, k1_shapes(LLAMA31_8B), TOKENS)
    rows += phase_flash(device)
    # K5b also at one pair and at the pairs of the longest call a MoE
    # block sends through the pairs kernel (64 tokens' top-2: 128); its
    # calls must run the decode GEMV
    from vptq_tpu_torch.models.llama import _MOE_FAST_MAX_TOKENS

    most = MIXTRAL_8X7B["num_experts_per_tok"] * _MOE_FAST_MAX_TOKENS
    for fmt in MOE_KERNELS:
        rows += phase_moe_kernels(
            fmt, device, moe_shapes(MIXTRAL_8X7B), tokens=TOKENS,
            pairs=(2, 16, 1, most) if fmt == "int4" else (2, 16),
            routes=routes,
        )
    # every decode call in one profiler session, the process's first: a
    # second session, for the eight K5b calls alone, recorded seven
    # kernels, three times running (alone in a process it records eight)
    check_decode_routes(routes, device)
    del routes
    t0 = time.perf_counter()
    rows += phase_probes(device)
    print(f"probe phase: {time.perf_counter() - t0:.2f} s")
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
