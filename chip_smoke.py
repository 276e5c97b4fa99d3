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
   largest instance, and at T=8, K2's the served step of 8 slots; K2 also
   at T=8192, the largest batched admission the serving phases can send:
   4 prompts of the 2048 bucket): the kernel held against its
   plain version on the card, then timed with CUDA events (L2 flushed
   before each launch) beside the plain version and a ``torch.matmul``
   yardstick; K1 also at the four shapes of Qwen2.5-7B (groups 512 and
   1024; intermediate 18944 padded to 19456), T=2048 included, and at
   the int8 side matrices of the mixed formats at Llama-3.1-8B width
   (group 128, 128 columns, down 384 or 512; T=1, 3, 16, 128, 512 and
   2048), outside the records, its calls of up to 16 tokens held to
   their routes;
   K7 at the Llama shapes on a random bf16 weight, at the same T (T > 16
   through the tile's SS form); K8 at Llama-3.1-8B's
   heads (32 over 8 KV heads of 128) on N(0, 1) q, k, v with v a strided
   view into a fused q|k|v row, at S=1024, 2048 and 1100 (no tile divides
   it), at Qwen2.5-7B's heads (28 over 4, GQA group 7) at S=2048, at head
   size 64, at head size 96 (Phi-3-mini's 32 heads; S=1024
   and 1100), with scores scaled to about +-50, and at Llama-3.1-8B's
   heads at B=2, 3 and 4, S=2048 (the scheduler's batched admissions of
   the 2048 bucket, a row a prompt), beside
   ``scaled_dot_product_attention`` as its yardstick;
3. the MoE kernels at Mixtral-8x7B's two expert shapes (gate_up
   28672 x 4096, down 4096 x 14336) on stacks of 8 experts that the int8
   and int4 encoders make on the card: K6a / K6b at T=1, 128, 512 and
   2048 (Mixtral's long chunk, through the tile; K6b also at T=8192, the
   largest batched admission; one expert, the last of
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
   and for the long prompt's prefill; then the runtime checkpoint's round
   trip in int8 and int4, the checkpoint cut to 4 layers at full width
   (to spare disk and time): loaded by re-encoding, written by
   ``tools/export_runtime.py``, read back byte-equal, the same greedy
   tokens from one request, the runtime load's seconds beside the
   re-encoding load's, the free disk printed first (a phase without room
   fails); and in int4, on the same loaded model, continuous batching:
   16 requests (prompts of 16, 128, 512 and 1536 tokens, four each, the
   1536-token ones sharing a 512-token head; 32-64 new tokens; two
   stopping at an EOS, two sampled at temperature 0.7 beside greedy
   neighbours) through one ``Scheduler`` (8 slots, ``max_seq`` 2048,
   chunks of 16, depth 2, 4 admissions at a time, buckets 128 / 512 /
   2048) with a ``PrefixCache``, every decode chunk through its batched
   CUDA graphs: each request returns its budget or ends at its EOS, its
   streamed tokens are its returned ones, its prefill and first decode
   logits are the same model's ``Generator``'s within ``LOGIT_TOL``, the
   prefix cache hits, every kernel's launches are exact over the
   scheduler's prefill calls and decode steps (K2 4 per layer and call;
   K8 once per layer for each batched admission of the 2048 bucket, at
   B = its prompts), the batched step's graphs equal its eager step bit
   for bit over 12 steps across a block boundary (slots of different lengths,
   greedy and sampled), and a profile of the replayed batched step holds
   K2 to its decode GEMV at T=8 and no device-to-host copy; printed: tok/s
   over the run, TTFT per request, the scheduler's stats, agreement with
   the Generator's tokens; then the same requests again on the warm
   scheduler, where every EOS must fire (a request whose EOS did not
   fire the first time takes its own second token of that run);
6. end to end in int8 and in int4 on one synthetic checkpoint of
   Mixtral-8x7B-v0.1 geometry (full width, 8 experts, top-2; depth cut
   to ``MIXTRAL_LAYERS`` = 16 of 32), the same four requests: per layer and forward
   call 2 launches of K1 / K2 (qkv, o), per layer and decode step 2 of
   K5, per layer and prefill chunk 16 of K6, K8 as above, every other
   kernel 0; the
   first prompt's prefill logits, and one decode step's, through the
   kernels against the plain versions; the profiled decode steps and the
   profiled long prefill must hold no device-to-host copy (the expert ids
   stay on the card); then the runtime checkpoint's round trip in int4
   (the stacked experts), 4 layers, as in phase 5; and in int4 the serving
   of phase 5 with 8 requests (two of each length): K5b 2 per layer and
   batched step at P=16, its decode-GEMV kernel in the trace, K6 16 per
   layer and prefill call;
7. end to end in int8 on one synthetic checkpoint of Qwen2.5-7B geometry
   (a bias on q, k and v; K1's first widths that pad; depth cut to
   ``CUT_LAYERS`` = 8, as in phases 8, 9 and 11), the same four
   requests, the long prompt's logits against the plain versions;
8. end to end in int8 on one synthetic checkpoint of Mistral-7B-v0.1
   geometry (sliding window 4096) with ``max_seq`` 8192: prompts of 16,
   512, 1536 and 4608 tokens (three chunks; positions from 4096 on lose
   their oldest keys). The window keeps every chunk out of K8, which
   must count 0;
9. end to end in int8 on one synthetic checkpoint of Phi-3-mini-4k
   geometry (q|k|v and gate|up stored fused, 32 heads of 96, sliding
   window 2047), written as four ``pytorch_model-*.bin`` shards with
   their ``pytorch_model.bin.index.json``, served by the ``Generator`` at
   ``max_seq`` 4096 as in phase 5: prompts of 16, 512, 1536 and 3000
   tokens (the last crosses the window, which keeps K8 at 0);
10. end to end in the mixed formats int2-mixed and int3-mixed at full
   Llama-3.1-8B width, depth cut to 4 (phase 12 serves a calibrated
   int2-mixed model from its runtime file at all 32): a model of random
   codes made
   on the card (``utils/synth.py`` ``mixed_model``, spread
   ``MIXED_STD``), written by ``export_runtime`` to a temporary directory
   (removed afterwards), read back by ``load_runtime_model`` (its
   seconds are the load) and held byte-equal, then served through
   ``Engine`` as in phase 5: every linear runs its base kernel (K3 or
   K4) and K1 on its side, 4 of each per layer and forward call; the
   graphs against ``decode_loop``, the logits against the plain versions
   (both kernels swapped) beside the model's own sensitivity to a
   one-ulp change of its embedding, the routes (K1's side on ``w8_gemv``
   at one token), no device-to-host copy;
11. end to end in int8 and in int4 on one synthetic checkpoint of
   Moonlight-16B-A3B geometry (DeepSeek-V3: layers of 2048, cut to
   ``CUT_LAYERS`` = 8 of its 27, MLA with a latent cache of 576 + 512 per token, the first layer dense, then 64
   routed experts of 1408, top 6 by sigmoid scores with a correction
   bias, and 2 shared experts; interleaved RoPE), written between
   Mixtral's run and Qwen's, the same four requests as phase 5: per
   forward call 5 launches of K1 / K2 a layer (q, kv_a, o; gate_up and
   down of the dense layer or of the shared experts), per MoE layer 2 of
   K5 a decode step and 128 of K6 a prefill chunk, K8 0 (MLA attends in
   its latent space); graphs against ``decode_loop``, logits against the
   plain versions, no device-to-host copy; in int4 the serving of phase 6
   (8 requests, 8 slots: K5b at P=48); then GPTQ calibration in int4 on
   the card (``load_model(runtime_format="int4", calibration=4096)``) of
   the checkpoint cut to 2 layers (the dense one; a MoE one: MLA's
   ``attn_in`` and ``o``, 64 experts, the shared ones), served as phase
   12 serves (the experts stacked: K2, K6b, K5b);
12. GPTQ calibration (M15) on the card at full Llama-3.1-8B width, on a
   checkpoint written at ``MIXED_STD``: first layer 0's ``o`` and
   ``down`` quantized by ``gptq_quantize`` on the card and on the CPU
   from the same weight and captured Hessian (``gptq_against_cpu``:
   codes in range, the first half of the columns alike but for
   ``GPTQ_HALF_SHARE``, error ratios within ``GPTQ_RATIO_TOL`` of each
   other and below RTN's; the share of codes that part, by eighths);
   then ``from_pretrained(runtime_format="int2-mixed")`` at all 32
   layers on 4096 synthetic tokens, and int3-mixed and int4-mixed on the
   checkpoint cut to 4 layers (``phase_calibrated``): the report's
   seconds (ranking, capture, GPTQ, propagation; per block), each site
   kind's formats, error ratios and int8 columns, int4-mixed's int8
   sites, the peak memory, the propagation forwards' launches (a
   mixed format's base kernel and K1, or K2 / K1, once per linear and
   block), each of those launches held against its kernel's plain
   version on the same inputs (f32 x of 8 x 512 tokens and an f32 out,
   a mixed layer's side on its gathered columns, every expert on every
   token); written by ``export_runtime``, read back byte-equal, and
   served from what was read as phase 10 serves (int4-mixed: K2 on its
   int4 sites, K1 on its int8 ones);
13. the user entry points (``phase_entry_points``) on phase 5's
   Llama-3.1-8B checkpoint (all 32 layers), before it is removed, with a
   byte tokenizer of the smoke's own (``ByteTokenizer``: the card's
   machine has no ``transformers``): the CLI (``cli._load`` in int8 at
   ``max_seq`` 4096, ``eval_prompt`` on 128 tokens, ``chat_loop`` over a
   turn, ``clear``, an empty line, a second turn and ``exit``; streamed
   ids = returned ids = the eager loop's; ``--tp 2`` refused naming M16),
   perplexity over two 4096-token windows (K1, and K8 once per layer a
   window; the mean NLL within 1e-2 nats of the plain versions', a
   window's NLL within 1e-5 of ``F.cross_entropy`` on its own logits,
   K1's and K8's busy ms in one window), ``qa.main --tokenizer byte`` over 32 ARC-Easy items in
   buckets 32 to 256 and their log-likelihoods against the plain
   versions, the web app (JSON and SSE chats, ``/api/stats`` against the
   weights and the card's memory, a switch to int4 that frees the int8
   model, K2 in its chat, an unknown name refused while int4 answers)
   and the reconstruction diagnostics of int8 and int4 against the
   codebook model, layers 0 and 31 recomputed on the CPU; every launch of
   it counted and held exact. Every phase prints its seconds
   (``seconds <phase>: N``).

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
from pathlib import Path
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
# microsoft's public Phi-3-mini-4k-instruct config.json (q|k|v and gate|up
# stored fused; sliding window 2047)
PHI3_MINI = dict(
    model_type="phi3",
    vocab_size=32064,
    hidden_size=3072,
    intermediate_size=8192,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=32,
    head_dim=96,
    rms_norm_eps=1e-5,
    rope_theta=10000.0,
    max_position_embeddings=4096,
    sliding_window=2047,
    tie_word_embeddings=False,
)
# moonshotai's public Moonlight-16B-A3B config.json (DeepseekV3ForCausalLM:
# MLA without q_lora_rank, 64 routed experts of 1408 and 2 shared, top 6,
# one dense layer first). The file has no rope_interleave key, which the
# JAX package and the port read as False; DeepSeek's own code always
# interleaves, so the smoke sets it and the card runs that branch.
MOONLIGHT_16B = dict(
    model_type="deepseek_v3",
    vocab_size=163840,
    hidden_size=2048,
    intermediate_size=11264,
    num_hidden_layers=27,
    num_attention_heads=16,
    num_key_value_heads=16,
    head_dim=128,
    rms_norm_eps=1e-5,
    rope_theta=50000.0,
    max_position_embeddings=8192,
    q_lora_rank=None,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_interleave=True,
    moe_intermediate_size=1408,
    n_routed_experts=64,
    n_shared_experts=2,
    num_experts_per_tok=6,
    n_group=1,
    topk_group=1,
    norm_topk_prob=True,
    routed_scaling_factor=2.446,
    first_k_dense_replace=1,
    tie_word_embeddings=False,
)
# deepseek-ai's public DeepSeek-R1 config.json: its routed experts only
# (256 of 7168 x 2048, top 8), for the MoE kernel phase; the whole model
# does not fit one card
R1_EXPERTS = dict(hidden_size=7168, moe_intermediate_size=2048,
                  n_routed_experts=256, num_experts_per_tok=8)
# the depth of the runs after Llama-3.1-8B's (full width): at full depth
# every phase together took 1234 s of the smoke's 1200 on one H100 80GB
# HBM3 at 700 W, the calibration phases included; Mixtral keeps half of
# its 32 layers (~24 GB of int8 weights), Moonlight, Qwen2.5, Mistral and
# Phi-3 keep 8
MIXTRAL_LAYERS = 16
CUT_LAYERS = 8
# VPTQ-community v8-k65536-0 geometry
V8_K65536 = dict(
    vector_len=8, num_centroids=65536, num_res_centroids=-1,
    enable_norm=True, enable_perm=True, is_indice_packed=True,
)
# codebook spread that keeps 32 synthetic layers' activations finite
SMOKE_STD = 0.02
# spread of the mixed formats' random codes (``utils/synth.py``
# mixed_model). At SMOKE_STD the int2-mixed model's own prefill logits
# move by more than LOGIT_TOL when its embedding moves by one bf16 ulp
# (``python -m vptq_tpu_torch.examples.mixed_sensitivity``), so that
# bound could not tell a right kernel from a wrong one; at this spread
# they move well inside it. phase_e2e reports that sensitivity beside the
# kernels' difference.
MIXED_STD = 0.01

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
# calibrated mixed format -> its base kernel and K1, which carries its
# int8 side matrix (y = base(x) + int8(x[..., col_idx]))
MIXED_KERNELS = {
    "int2-mixed": ("w2_matmul", "w8_matmul"),
    "int3-mixed": ("w3_matmul", "w8_matmul"),
}
# int4-mixed (calibrated): K2 on its int4 sites, K1 on its int8 ones
CALIBRATED_KERNELS = {"int4-mixed": ("w4_matmul", "w8_matmul")}
# a runtime layer's type -> the kernel its forward launches
LAYER_KERNEL = {
    "Int8Linear": "w8_matmul", "Int4Linear": "w4_matmul",
    "Int3Linear": "w3_matmul", "Int2Linear": "w2_matmul",
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
# K1 / K2 at DeepSeek's shapes: decode, the 8 slots' step, the decode
# GEMV's largest instance, two prefill buckets
DEEPSEEK_TOKENS = (1, 8, 16, 128, 512)
# K1 at the mixed formats' side matrices: w8_gemv (T = 1), the decode
# GEMV (3, 16) and the tile (past 16)
SIDE_TOKENS = (1, 3, 16, 128, 512, 2048)
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


def format_kernels(fmt: str) -> tuple:
    """The kernels the decoder linears of ``fmt`` run: its format's, a
    mixed format's base kernel and K1, or int4-mixed's K2 and K1."""
    return (MIXED_KERNELS.get(fmt) or CALIBRATED_KERNELS.get(fmt)
            or (FORMAT_KERNEL.get(fmt),))


def _sh(cmd) -> str:
    return subprocess.run(
        cmd, capture_output=True, text=True, check=True
    ).stdout.strip()


@contextlib.contextmanager
def timed(what: str):
    """Prints the seconds of the block it wraps."""
    t0 = time.perf_counter()
    yield
    print(f"seconds {what}: {time.perf_counter() - t0:.2f}", flush=True)


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
    """(name, out, in) of the four linears of one decoder layer; of a
    DeepSeek model, every K1 / K2 shape: MLA's q (or q_a, q_b), kv_a and
    o, the dense first layers' gate_up and down, the shared experts'."""
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    if cfg.get("kv_lora_rank"):
        nh, q_lora = cfg["num_attention_heads"], cfg.get("q_lora_rank")
        qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
        shared = cfg["moe_intermediate_size"] * cfg["n_shared_experts"]
        q = ([("q_a", q_lora, h), ("q_b", nh * qk, q_lora)] if q_lora
             else [("q", nh * qk, h)])
        return q + [
            ("kv_a", cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"], h),
            ("o", h, nh * cfg["v_head_dim"]),
            ("dense gate_up", 2 * inter, h), ("dense down", h, inter),
            ("shared gate_up", 2 * shared, h), ("shared down", h, shared),
        ]
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
    # the scheduler's batched admissions of the 2048 bucket: a row a
    # prompt, up to admit_parallel (4)
    *(("llama-3.1-8b heads, batched admission", b, 2048, 32, 8, 128, 1.0,
       False) for b in (2, 3, 4)),
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
    h = cfg["hidden_size"]
    inter = cfg.get("moe_intermediate_size") or cfg["intermediate_size"]
    return [("gate_up", 2 * inter, h), ("down", h, inter)]


def phase_moe_kernels(fmt, device, shapes, n_experts=8, tokens=(1, 128, 512),
                      pairs=(2, 16), top_k=2, iters=20, seed=0, routes=None,
                      in_record=True):
    """The expert (K6) and pairs (K5) kernels of ``fmt`` at each shape, on
    a stack of ``n_experts`` that the format's encoder makes on ``device``:
    the expert kernel on the stack's last expert at each token count, the
    pairs kernel on the first P of the top-``top_k`` ids of ⌈P / top_k⌉
    tokens (distinct per token, drawn from ``seed``). ``routes``: a list
    to which each pairs call on the card of a kernel with a decode-GEMV
    family is appended with its row, for :func:`check_decode_routes`;
    ``in_record`` as for :func:`phase_kernel`."""
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
                in_record=in_record,
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
                in_record=in_record,
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
                     qkv_bias=False, bin_shards=0):
    """The synthetic checkpoint every format loads (``bin_shards`` > 0: as
    that many ``pytorch_model*.bin`` pickles); returns (dir, s)."""
    from vptq_tpu_torch.utils.synth_checkpoint import (
        tiny_model_config,
        write_synthetic_checkpoint,
    )

    path = tempfile.mkdtemp(prefix="vptq_smoke_")
    t0 = time.perf_counter()
    write_synthetic_checkpoint(
        path, tiny_model_config(**cfg), vq_kwargs=vq_kwargs, seed=seed,
        std=std, qkv_bias=qkv_bias, bin_shards=bin_shards,
    )
    return path, time.perf_counter() - t0


def expected_launches(cfg, fmt: str, prompt_len: int, new_tokens: int,
                      buckets, dtype=torch.bfloat16, per_call=None) -> dict:
    """Launches of every kernel in one request on the card: the prompt in
    bucket-padded chunks, the first one fresh, then one forward call per
    further token (:func:`launches_of`)."""
    from vptq_tpu_torch.serving.generate import _pad_bucket

    calls = [
        (1, _pad_bucket(min(buckets[-1], prompt_len - done), buckets),
         done == 0)
        for done in range(0, prompt_len, buckets[-1])
    ] + [(1, 1, False)] * (new_tokens - 1)
    return launches_of(cfg, fmt, calls, dtype, per_call)


def launches_of(cfg, fmt: str, calls, dtype=torch.bfloat16,
                per_call=None) -> dict:
    """Launches of every kernel over forward calls, each (rows, tokens a
    row, fresh): a fresh call of 1024 tokens or more a row, when the
    model has no sliding window and K8 is built for ``dtype`` and the head
    size, goes through K8 once per layer (at B = rows). A mixed format's
    linear runs its base kernel and K1 once each. A MoE block sends a call
    of at most 64 tokens in all through the pairs kernel twice (P = top-k
    · tokens), and a longer one through the expert kernel 2·E times. K7
    is on no path; MLA never reaches K8. ``per_call``: each linear
    kernel's launches a forward call where the format does not fix them
    (int4-mixed: :func:`linear_launches` of the model)."""
    from vptq_tpu_torch.models.llama import _MOE_FAST_MAX_TOKENS, takes_flash

    layers = cfg.num_hidden_layers
    expected = dict.fromkeys(ALL_KERNELS, 0)
    if not cfg.is_mla:  # MLA never reaches K8
        expected[FLASH] = layers * sum(
            bool(fresh) and takes_flash(cfg, seq, dtype)
            for _, seq, fresh in calls
        )
    linears, moe_layers, experts = layer_linears(cfg)
    for kernel in format_kernels(fmt):
        expected[kernel] = (
            linears if per_call is None else per_call[kernel]) * len(calls)
    if not moe_layers:
        return expected
    expert, pairs = MOE_KERNELS[fmt]
    fast = sum(rows * seq <= _MOE_FAST_MAX_TOKENS for rows, seq, _ in calls)
    expected[pairs] = 2 * moe_layers * fast
    expected[expert] = 2 * experts * moe_layers * (len(calls) - fast)
    return expected


def layer_linears(cfg) -> tuple:
    """(the decoder linears of all layers, each one launch of the format's
    kernel a forward call once fused; the MoE layers; their routed
    experts): dense 4 a layer; Mixtral 2 (qkv, o); DeepSeek MLA's q (or
    q_a, q_b), kv_a and o, and 2 more (gate_up, down) in its dense first
    layers and its shared experts."""
    layers = cfg.num_hidden_layers
    if cfg.is_mla:
        attn = 3 + bool(cfg.q_lora_rank)
        dense = min(cfg.first_k_dense_replace, layers)
        moe = (layers - dense) if cfg.n_routed_experts else 0
        return (attn + 2) * layers, moe, cfg.n_routed_experts
    if cfg.num_local_experts:
        return 2 * layers, layers, cfg.num_local_experts
    return 4 * layers, 0, 0


@contextlib.contextmanager
def plain_versions(fmt: str):
    """Every kernel the model reaches in ``fmt`` swapped for its plain
    version (a mixed format's base kernel and K1 both), for the
    comparisons only."""
    from vptq_tpu_torch.layers import runtime
    from vptq_tpu_torch.models import llama

    with contextlib.ExitStack() as stack:
        for name in format_kernels(fmt):
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


# the Scheduler of the serving phases: 8 slots, chunks of 16 steps, two in
# flight, 4 admissions at a time, the Generator's buckets, a prefix cache
SERVE = dict(max_batch=8, max_seq=2048, chunk=16, depth=2, admit_parallel=4,
             prompt_buckets=(128, 512, 2048))


def serving_requests(gen, vocab: int, prompt_lens, per_len: int, seed=0,
                     shared=512):
    """``per_len`` requests of each prompt length, from the seed,
    interleaved by length: the longest ones share their first ``shared``
    tokens (the prefix cache's hits); budgets 32 to 64; the first two of
    the shortest length stop at an EOS, the token the model gives at
    position 1 or 4 of its greedy output alone (``gen``: the batched
    routes may part from it before); two of the others are sampled at
    temperature 0.7. Each is a dict of ``submit``'s arguments."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, shared).tolist()
    out = []
    for i in range(per_len):
        for n in prompt_lens:
            prompt = rng.integers(0, vocab, n).tolist()
            if n == max(prompt_lens) and n > shared:
                prompt[:shared] = head
            out.append(dict(prompt_tokens=prompt,
                            max_new_tokens=int(rng.integers(32, 65))))
    for k, req in zip((1, 4), out[:: len(prompt_lens)]):
        ref = gen.generate(req["prompt_tokens"], max_new_tokens=k + 1)
        req["eos_token_id"] = ref[-1]
    for i, req in enumerate(out[1:3]):
        req.update(temperature=0.7, seed=11 + i)
    return out


def batched_state(sched, lengths, seed=0, temps=(0.0, 0.7)):
    """Every slot of ``sched`` decoding from ``lengths`` cached tokens
    (whatever its rows hold), random last tokens, temperatures cycling
    through ``temps``: the state the batched step is checked and timed
    from."""
    decode, cache = sched.decode, sched.cache
    gen = torch.Generator().manual_seed(seed)
    batch = len(lengths)
    cache.lengths.copy_(torch.tensor(lengths))
    cache.max_len = max(lengths)
    decode.tok.copy_(torch.randint(0, sched.model.cfg.vocab_size, (batch,),
                                   generator=gen))
    decode.temps.copy_(torch.tensor(
        [temps[i % len(temps)] for i in range(batch)], dtype=torch.float32))
    decode.set_active([True] * batch)


def batched_graph_against_eager(sched, lengths, steps=12, seed=5):
    """``steps`` batched steps from :func:`batched_state` through the
    graphs (twice: the second run replays every graph the first may have
    captured) and then eagerly (``BatchedDecode.eager_step``, a fresh
    generator of the same seed): every step's logits and tokens bit for
    bit, or it fails. Returns the block counts the steps ran."""
    from vptq_tpu_torch.serving.generate import decode_plan

    decode = sched.decode
    device = sched.cache.lengths.device
    with torch.inference_mode():
        for _ in range(2):
            batched_state(sched, lengths)
            decode.begin(seed)
            got = [decode.step().clone() for _ in range(steps)]
            got_toks = decode.tokens[:steps].clone()
        batched_state(sched, lengths)
        graphed = decode.generator
        decode.generator = torch.Generator(device=device)
        decode.begin(seed)
        want = [decode.eager_step().clone() for _ in range(steps)]
        decode.generator = graphed
        want_toks = decode.tokens[:steps].clone()
    if not torch.equal(got_toks, want_toks):
        raise AssertionError("batched graph tokens differ from eager")
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            raise AssertionError(
                f"batched step {i}: graph logits differ from eager by "
                f"{(g - w).abs().max().item()}")
    return sorted(set(decode_plan(max(lengths), steps, sched.max_seq)))


def batched_breakdown(sched, lengths, tags: dict, fmt: str, steps=8):
    """The batched graphed step of every slot (from :func:`batched_state`):
    wall time (host clock over ``steps`` replays, synchronized) against
    the device time the replays' kernels take (``torch.profiler`` over the
    same steps run again), the kernels per step, the routes at one token
    a slot (:func:`step_routes`: K2 at T = 8, K5b at P = 16), no
    device-to-host copy inside the chunk."""
    from torch.profiler import ProfilerActivity, profile

    decode = sched.decode
    device = sched.cache.lengths.device
    batch = len(lengths)

    def run(n):
        decode.begin(0)  # the chunk's token buffer from its first row
        for _ in range(n):
            decode.step()
        torch.cuda.synchronize(device)

    with torch.inference_mode():
        batched_state(sched, lengths)
        run(2)
        t0 = time.perf_counter()
        run(steps)
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(steps)
    events = _device_events(prof)
    busy_ms = sum(e.device_time_total for e in events) / 1e3 / steps
    out = dict(
        slots=batch, wall_ms=wall_ms, tok_s=batch * 1e3 / wall_ms,
        device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
        kernels_per_step=len(events) / steps,
        families=kernel_families(events, steps),
        kernel_ms=_kernel_ms(events, tags, "batched graph decode", per=steps),
        device_to_host_copies=_device_to_host(
            events, f"{steps} replayed batched steps"),
        routes=step_routes(events, sched.model, fmt, "batched replayed step",
                           tokens=batch),
        graphs=len(decode.captured),
        pool_mb=decode.pool_bytes() / 1e6,
    )
    print("batched graph decode step " + json.dumps(out))
    return out


def served_run(sched, reqs):
    """``reqs`` submitted at once and run to the end: (request ids, their
    outputs, their streamed tokens, wall seconds, TTFT seconds by prompt
    length, device seconds), the host clock synchronized at both ends. On
    the card the device seconds are those of the prefill calls and of the
    decode chunks (CUDA events around each, in stream order: nothing else
    runs between a pair), the idle share 1 - their sum over the wall."""
    stamps, streamed, spans = {}, {}, {"prefill_s": [], "decode_s": []}

    def stream(rid, tok):
        stamps.setdefault(rid, time.perf_counter())
        streamed.setdefault(rid, []).append(tok)

    device = sched.cache.lengths.device
    cuda = device.type == "cuda"

    def timed(fn, what):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[what].append((start, end))
            return out
        return call

    # what the instances held before (a spy, or nothing: the class's
    # method), put back after; a bound method left in an attribute would
    # hold the scheduler in a reference cycle
    wrapped = [(o, n, vars(o).get(n)) for o, n in (
        (sched, "_prefill_one"), (sched, "_prefill_fresh_batch"),
        (sched.decode, "run"))] if cuda else []
    for o, n, _ in wrapped:
        setattr(o, n, timed(getattr(o, n),
                            "decode_s" if n == "run" else "prefill_s"))
    _sync(device)
    t0 = time.perf_counter()
    ids = [sched.submit(**r, stream_callback=stream) for r in reqs]
    outs = sched.run()
    _sync(device)
    wall_s = time.perf_counter() - t0
    for o, n, held in wrapped:
        if held is None:
            delattr(o, n)
        else:
            setattr(o, n, held)
    ttft = {}
    for rid, req in zip(ids, reqs):
        ttft.setdefault(len(req["prompt_tokens"]), []).append(
            stamps[rid] - t0)
    device_s = {k: sum(a.elapsed_time(b) for a, b in v) / 1e3
                for k, v in spans.items()}
    if cuda:
        device_s["idle_share"] = 1.0 - sum(device_s.values()) / wall_s
    return ids, {i: outs[i] for i in ids}, streamed, wall_s, ttft, device_s


def served_outputs(ids, reqs, outs, streamed, vocab: int) -> int:
    """Every request's output streamed as returned, of valid tokens, and
    its budget long or ended at its EOS: the number of EOS that fired."""
    eos_fired = 0
    for rid, req in zip(ids, reqs):
        out = outs[rid]
        if streamed.get(rid) != out:
            raise AssertionError(f"request {rid}: streamed tokens differ")
        eos = req.get("eos_token_id")
        if not all(0 <= t < vocab for t in out):
            raise AssertionError(f"request {rid}: bad tokens {out}")
        if eos is not None and eos in out:
            if out.index(eos) != len(out) - 1:
                raise AssertionError(f"request {rid} ran past its EOS")
            eos_fired += 1
        elif len(out) != req["max_new_tokens"]:
            raise AssertionError(f"request {rid}: {len(out)} tokens, "
                                 f"budget {req['max_new_tokens']}")
    return eos_fired


def phase_serving(model, gen, fmt: str, vocab: int, prompt_lens=(16, 128,
                  512, 1536), per_len=4, serve=None, shared=512, seed=0):
    """Continuous batching on the loaded model: ``per_len`` requests of each
    prompt length (:func:`serving_requests`) through one ``Scheduler``
    (``SERVE``) with a ``PrefixCache``, every decode chunk through its
    batched CUDA graphs on the card. Held: every request returns its
    budget or ends at its EOS, streamed tokens equal returned ones; each
    request's prefill logits and first decode logits against the same
    model's ``Generator`` on that prompt within ``LOGIT_TOL``; launch
    counts exact (:func:`launches_of` over the prefill calls the
    scheduler made and its decode steps: K8 once a layer for each batched
    admission of the 2048 bucket, at B = its prompts); the prefix cache
    hit; on the warm rerun every EOS request stops at its EOS. On the
    card also: the batched step's graphs against its eager step bit for
    bit, across a block boundary, greedy and sampled slots side by side;
    the graphed step's trace (routes at T = 8 / P = 16, no device-to-host
    copy). Printed: token agreement with the Generator (not required: T =
    8 and T = 1 take other routes), how many EOS fired, hits, the
    scheduler's stats, generated tokens a second, TTFT per request, and
    the same requests run again on the warm scheduler."""
    from vptq_tpu_torch.models.llama import forward
    from vptq_tpu_torch.serving.prefix_cache import PrefixCache
    from vptq_tpu_torch.serving.scheduler import Scheduler

    serve = dict(SERVE, **(serve or {}))
    device = model.embed_tokens.device
    cuda = device.type == "cuda"
    cfg = model.cfg
    fns = {k: kernel_fns(k)[0] for k in ALL_KERNELS}
    with torch.inference_mode():
        reqs = serving_requests(gen, vocab, prompt_lens, per_len, seed,
                                shared)
    sched = Scheduler(model, dtype=gen.dtype,
                      prefix_cache=PrefixCache(block_size=64), **serve)

    # what the run did: prefill calls (rows, tokens a row, fresh), each
    # request's prefill logits and first decode logits
    calls, prefill_logits, decode_logits, starting = [], {}, {}, {}
    one, batch = sched._prefill_one, sched._prefill_fresh_batch

    def prefill_one(tokens, cache1, start, fresh=False):
        calls.append((1, tokens.shape[1], fresh))
        return one(tokens, cache1, start, fresh)

    def prefill_batch(tokens):
        calls.append((tokens.shape[0], tokens.shape[1], True))
        return batch(tokens)

    finish, install, step = (sched._finish_admission, sched._install,
                             sched.decode.step)

    def finish_admission(adm):
        prefill_logits[adm.req.req_id] = adm.last_logits.clone()
        finish(adm)

    def install_slot(req, cache1, row, plen, first, slot):
        install(req, cache1, row, plen, first, slot)
        starting[slot] = req.req_id

    def decode_step():
        logits = step()
        for slot, rid in starting.items():
            decode_logits[rid] = logits[slot].clone()
        starting.clear()
        return logits

    sched._prefill_one, sched._prefill_fresh_batch = prefill_one, prefill_batch
    sched._finish_admission, sched._install = finish_admission, install_slot
    sched.decode.step = decode_step

    for f in fns.values():
        f.launches = 0
    ids, outs, streamed, wall_s, ttft, device_s = served_run(sched, reqs)
    counts = {k: f.launches for k, f in fns.items()}
    # the class's own methods again (the spies would also hold the
    # scheduler in a reference cycle)
    del sched.decode.step
    for name in ("_prefill_one", "_prefill_fresh_batch", "_finish_admission",
                 "_install"):
        delattr(sched, name)

    steps = sched.stats["chunks"] * sched.chunk
    expected = launches_of(
        cfg, fmt, calls + [(sched.max_batch, 1, False)] * steps, gen.dtype)
    if not cuda:
        expected = dict.fromkeys(expected, 0)
    if counts != expected:
        raise AssertionError(f"{fmt} serving: launches {counts}, "
                             f"expected {expected}")
    eos_fired = served_outputs(ids, reqs, outs, streamed, vocab)
    hits = sched.prefix_cache.hits
    if hits < 1:
        raise AssertionError(f"{fmt} serving: no prefix-cache hit")

    # each request's prefill and first decode logits against the
    # Generator's on the same prompt (its first token fed back)
    diffs, agree = [], []
    with torch.inference_mode():
        for rid, req in zip(ids, reqs):
            prompt = req["prompt_tokens"]
            want = prefill(model, gen, prompt)[-1]
            step_logits, _ = forward(
                model, torch.tensor([[outs[rid][0]]], device=device),
                gen.cache, dtype=gen.dtype)
            for what, g, w in (("prefill", prefill_logits[rid], want),
                               ("decode", decode_logits.get(rid),
                                step_logits[0, 0])):
                if g is None:  # a request that stopped at its first token
                    continue
                diff = (g - w).abs().max().item()
                scale = w.abs().max().item()
                diffs.append(diff / scale)
                if not (diff <= LOGIT_TOL * scale
                        and bool(torch.isfinite(g).all())):
                    raise AssertionError(
                        f"request {rid} ({len(prompt)} tokens): {what} "
                        f"logits differ from the Generator's by {diff} "
                        f"(max {scale})")
            if not req.get("temperature") and req.get("eos_token_id") is None:
                alone = gen.generate(prompt,
                                     max_new_tokens=req["max_new_tokens"])
                agree.append(sum(a == b for a, b in zip(alone, outs[rid]))
                             / len(alone))
    tokens = sum(len(o) for o in outs.values())
    result = dict(
        format=fmt, requests=len(reqs), slots=sched.max_batch,
        wall_s=wall_s, tokens=tokens, tok_s=tokens / wall_s, ttft_s=ttft,
        device_s=device_s,
        prefix_hits=hits, prefix_blocks=sched.prefix_cache.num_blocks,
        eos_fired=eos_fired, stats=dict(sched.stats),
        prefill_calls=[list(c) for c in calls],
        launches={k: n for k, n in counts.items() if n},
        logits_max_rel_diff=max(diffs),
        greedy_token_agreement=agree,
    )
    # the same requests again on the warm scheduler (graphs captured,
    # caches pooled, the prefix cache emptied): no first-use costs. A
    # request whose EOS did not fire takes its own second token of the
    # first run as EOS, which the same greedy run gives again: every EOS
    # must fire now
    sched.prefix_cache.clear()
    warm = [dict(r) for r in reqs]
    for rid, req in zip(ids, warm):
        if req.get("eos_token_id") not in (None, *outs[rid]):
            req["eos_token_id"] = outs[rid][1]
    before = dict(sched.stats)
    warm_ids, again, warm_streamed, warm_s, warm_ttft, warm_device = (
        served_run(sched, warm))
    warm_eos = served_outputs(warm_ids, warm, again, warm_streamed, vocab)
    want_eos = sum(r.get("eos_token_id") is not None for r in warm)
    if warm_eos != want_eos:
        raise AssertionError(f"{fmt} serving: {warm_eos} of {want_eos} EOS "
                             "fired on the warm run")
    tokens = sum(len(o) for o in again.values())
    result["warm"] = dict(
        wall_s=warm_s, tokens=tokens, tok_s=tokens / warm_s,
        ttft_s=warm_ttft, device_s=warm_device, eos_fired=warm_eos,
        stats={k: sched.stats[k] - n for k, n in before.items()},
    )
    print(f"serving run {fmt} " + json.dumps(result))
    if cuda:
        # slots of different lengths, the longest crossing 1024 (blocks 4
        # to 5) in the 12 steps; greedy and sampled slots side by side
        lengths = [1014, 3, 250, 600, 17, 900, 1009, 128][: sched.max_batch]
        result["batched_graph_vs_eager_blocks"] = batched_graph_against_eager(
            sched, lengths)
        in_decode = [k for k in result["launches"]
                     if not k.endswith("_expert") and k != FLASH]
        result["batched_step"] = batched_breakdown(
            sched, lengths, {k: fns[k].trace_tags for k in in_decode}, fmt)
    print(f"serving {fmt} " + json.dumps(result))
    del sched
    if cuda:
        torch.cuda.empty_cache()
    return result


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


def phase_e2e(device, source, fmt: str, vocab: int,
              prompt_lens=(16, 128, 512, 1536), new_tokens=32, max_seq=2048,
              seed=0, load_s=None, sensitivity=False, serve=None):
    """from_pretrained(runtime_format=fmt) → one greedy request per prompt
    length, each decode chunk through the generator's CUDA graphs on the
    card; launch counts (replays included), logits, a decode step and,
    for a prompt that takes the flash kernel, its prefill checked. On the
    card the graphs are held to the eager plain loop: the first request's
    tokens, and a run that crosses a 256-position block boundary, greedy
    and sampled, logits bit for bit. Serves whatever ``source`` holds: a
    checkpoint directory (dense Llama, Qwen2, Mistral or Mixtral), or a
    model already loaded in ``fmt`` (a runtime checkpoint's, read in
    ``load_s`` seconds), served through ``Engine``. A dense model in int8
    also holds its longest flash prompt's logits against the plain
    versions (K8 swapped with K1). ``sensitivity``: also the model's own
    conditioning, the plain prefill logits again on an embedding whose
    entries each move by at most one bf16 ulp (times 1 ± 2^-8).
    ``serve``: then :func:`phase_serving` on the same model, with these
    arguments. int4-mixed counts each kernel's launches from the model's
    layers (:func:`linear_launches`)."""
    from vptq_tpu_torch import AutoModelForCausalLM
    from vptq_tpu_torch.api import Engine
    from vptq_tpu_torch.models.llama import forward

    fns = {k: kernel_fns(k)[0] for k in ALL_KERNELS}
    cuda = torch.device(device).type == "cuda"
    result = dict(format=fmt)
    if isinstance(source, str):
        t0 = time.perf_counter()
        engine = AutoModelForCausalLM.from_pretrained(
            source, runtime_format=fmt, device=device, max_seq=max_seq
        )
        _sync(device)
        load_s = time.perf_counter() - t0
    else:
        engine = Engine(source, max_seq=max_seq)
    result["load_s"] = load_s

    model, gen = engine.model, engine.generator
    cfg = model.cfg
    moe = bool(layer_linears(cfg)[1])
    buckets = gen.prompt_buckets
    per_call = (linear_launches(model, fmt) if fmt in CALIBRATED_KERNELS
                else None)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n).tolist() for n in prompt_lens]
    flash = [
        p for p in prompts
        if expected_launches(cfg, fmt, len(p), 1, buckets, gen.dtype,
                             per_call)[FLASH]
    ]
    on_path = (
        *format_kernels(fmt), *(MOE_KERNELS[fmt] if moe else ()),
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
            cfg, fmt, len(prompt), len(out), buckets, gen.dtype, per_call
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
        return want

    for prompt in prompts:
        if not bool(torch.isfinite(logits_of(prompt)[0]).all()):
            raise AssertionError(
                f"{fmt}: non-finite logits for a {len(prompt)}-token prompt"
            )
    want = hold_to_plain(prompts[0], ("prefill", "decode"))[0]
    if sensitivity:
        from vptq_tpu_torch.examples.mixed_sensitivity import nudged

        embed = model.embed_tokens
        model.embed_tokens = nudged(embed, seed)
        with plain_versions(fmt):
            moved = logits_of(prompts[0])[0]
        model.embed_tokens = embed
        result["prefill_logits_sensitivity"] = (
            (moved - want).abs().max() / want.abs().max()).item()
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
    if serve is not None:
        result["serving"] = phase_serving(model, gen, fmt, vocab, **serve)
    del engine, model, gen
    if cuda:
        torch.cuda.empty_cache()
    return result


def side_shapes(cfg: dict, fmt: str):
    """(name, out, in) of the int8 side matrices of ``fmt``'s four mixed
    sites in one decoder layer of ``cfg``: ``in`` is the side's column
    count, by calibration's rule (``utils/synth.py`` ``mixed_cols``)."""
    from vptq_tpu_torch.utils.synth import MIXED_FORMATS, mixed_cols

    fraction = MIXED_FORMATS[fmt][1]
    out = []
    for name, out_f, in_f in k1_shapes(cfg):
        k = mixed_cols(in_f, fraction)
        out.append((f"{name} side {k}", out_f, k))
    return out


def disk_room(path, what: str, need: int = 0) -> dict:
    """shutil.disk_usage where ``path`` lies, printed; fails (the phase is
    not skipped) unless ``need`` bytes and 1 GB beside them fit."""
    usage = shutil.disk_usage(path)
    out = dict(path=str(path), total_gb=usage.total / 1e9,
               free_gb=usage.free / 1e9, need_gb=need / 1e9)
    print(f"disk {what} " + json.dumps(out))
    if usage.free < need + (1 << 30):
        raise AssertionError(
            f"{what}: {need / 1e9:.2f} GB to write, {usage.free / 1e9:.2f} "
            f"GB free at {path}")
    return out


def buffer_bytes(model) -> int:
    return sum(b.numel() * b.element_size() for b in model.buffers())


def same_buffers(want, got, what: str) -> int:
    """Fails unless two models hold the same tensors under the same names,
    byte for byte, and the same config; returns the bytes compared."""
    a, b = dict(want.named_buffers()), dict(got.named_buffers())
    if a.keys() != b.keys() or want.cfg != got.cfg:
        raise AssertionError(
            f"{what}: tensors {sorted(a.keys() ^ b.keys())[:4]} or the "
            "config differ")
    for name, t in a.items():
        u = b[name]
        if (t.dtype != u.dtype or t.shape != u.shape or not torch.equal(
                t.reshape(-1).view(torch.uint8),
                u.reshape(-1).view(torch.uint8))):
            raise AssertionError(f"{what}: {name} read back differs")
    return buffer_bytes(want)


def phase_mixed(device, cfg: dict, fmt: str, seed=0, **e2e_kwargs):
    """A calibrated mixed format at ``cfg``'s full geometry through the
    port's runtime checkpoint: a model of random codes built on the card
    (``utils/synth.py`` ``mixed_model``: side columns spread evenly,
    calibration's count rule, side scale group 128), written by
    ``export_runtime`` to a temporary directory (removed afterwards),
    read back by ``load_runtime_model`` and held byte-equal to what was
    written, then served by :func:`phase_e2e` through ``Engine``."""
    from vptq_tpu_torch.models.llama import ModelConfig
    from vptq_tpu_torch.tools.export_runtime import (
        export_runtime,
        load_runtime_model,
    )
    from vptq_tpu_torch.utils.synth import mixed_model

    path = tempfile.mkdtemp(prefix="vptq_mixed_")
    try:
        disk_room(path, f"{fmt} (before the build)")
        t0 = time.perf_counter()
        model = mixed_model(ModelConfig(**cfg), fmt, device, seed=seed,
                            std=MIXED_STD)
        _sync(device)
        made = dict(build_s=time.perf_counter() - t0,
                    disk=disk_room(path, fmt, buffer_bytes(model)))
        t0 = time.perf_counter()
        export_runtime(model, path)
        made["write_s"] = time.perf_counter() - t0
        made["file_gb"] = sum(
            f.stat().st_size for f in Path(path).iterdir()) / 1e9
        t0 = time.perf_counter()
        loaded = load_runtime_model(path, device)
        _sync(device)
        load_s = time.perf_counter() - t0
        made["bytes_equal_gb"] = same_buffers(model, loaded, fmt) / 1e9
        print(f"runtime checkpoint {fmt} " + json.dumps(made))
        del model
        result = phase_e2e(device, loaded, fmt, cfg["vocab_size"],
                           load_s=load_s, sensitivity=True, **e2e_kwargs)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    result["runtime_checkpoint"] = made
    return result


def cut_checkpoint(path, layers: int) -> Path:
    """A temporary directory holding the checkpoint at ``path`` cut to its
    first ``layers`` layers: its config.json so edited, links to its
    safetensors shards (the loader reads the layers the config names)."""
    cut = Path(tempfile.mkdtemp(prefix="vptq_cut_"))
    with open(Path(path) / "config.json") as f:
        hf = json.load(f)
    hf["num_hidden_layers"] = layers
    with open(cut / "config.json", "w") as f:
        json.dump(hf, f)
    for shard in Path(path).glob("*.safetensors"):
        (cut / shard.name).symlink_to(shard.resolve())
    return cut


def phase_round_trip(device, path, fmt: str, vocab: int, layers=4,
                     prompt_len=16, new_tokens=8, max_seq=256, seed=0):
    """The runtime checkpoint at full width, depth cut to ``layers`` to
    spare disk and time: the VPTQ checkpoint at ``path`` cut to its first
    ``layers`` (its config.json, its shards linked) is loaded in ``fmt``
    by re-encoding, written by ``export_runtime``, read back by
    ``load_runtime_model`` and held byte-equal; one greedy request from
    each gives the same tokens. Returns the runtime load's seconds beside
    the re-encoding load's."""
    from vptq_tpu_torch.api import Engine
    from vptq_tpu_torch.models.loader import load_model
    from vptq_tpu_torch.tools.export_runtime import (
        export_runtime,
        load_runtime_model,
    )

    cut = cut_checkpoint(path, layers)
    out = tempfile.mkdtemp(prefix="vptq_rt_")
    try:
        disk_room(out, f"{fmt} round trip (before the load)")
        t0 = time.perf_counter()
        model = load_model(str(cut), runtime_format=fmt, device=device)
        _sync(device)
        result = dict(format=fmt, layers=layers,
                      reencode_load_s=time.perf_counter() - t0)
        disk_room(out, f"{fmt} round trip", buffer_bytes(model))
        t0 = time.perf_counter()
        export_runtime(model, out)
        result["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_runtime_model(out, device)
        _sync(device)
        result["runtime_load_s"] = time.perf_counter() - t0
        result["bytes_equal_gb"] = same_buffers(model, back, fmt) / 1e9
        prompt = np.random.default_rng(seed).integers(
            0, vocab, prompt_len).tolist()
        tokens = [Engine(m, max_seq=max_seq).generate(
            prompt, max_new_tokens=new_tokens) for m in (model, back)]
        if tokens[0] != tokens[1] or len(tokens[0]) != new_tokens:
            raise AssertionError(f"{fmt}: tokens {tokens[1]} read back, "
                                 f"{tokens[0]} re-encoded")
        result["tokens_identical"] = True
    finally:
        shutil.rmtree(cut, ignore_errors=True)
        shutil.rmtree(out, ignore_errors=True)
    print("round trip " + json.dumps(result))
    return result


# the linears of one calibration site (q|k|v, gate|up; MLA's q and kv_a)
SITE_MEMBERS = {"qkv": 3, "gate_up": 2, "attn_in": 2}
# layer 0's sites whose GPTQ the card holds against the CPU's
GPTQ_SITES = (("o", "attn.o_proj"), ("down", "mlp.down_proj"))
# the card's GPTQ against its plain version on the CPU (the same w and H,
# captured at full width). The codes part along the row: the factor of
# an ill-conditioned H (layer 0's: condition ~1e5–1e6 after damping) and
# the products round in another order, a code that flips feeds another
# error to every later column of its row, and over thousands of columns
# the two runs drift apart (the share that differs is printed by eighths
# of the columns; CPU tests hold the codes at 512 columns). Held: in the
# first half of the columns at most GPTQ_HALF_SHARE of the codes differ;
# the H-weighted output error ratios lie within GPTQ_RATIO_TOL of each
# other and both below RTN's / GPTQ_GAIN. The limits sit above what one
# H100 read on two checkpoints of the same seed (32 layers, twice, the
# same both times; 4 layers): o 3.11% / 3.00% of the first half's codes
# apart and ratios 0.50% / 0.33%, down 0.20% / 0.20% and 6.22% / 12.0%
# (down's ratios, ~2.5e-9, are 4e6 times below RTN's: what is left lies
# where H is near null, and two rounding orders leave it in other
# columns).
GPTQ_HALF_SHARE = 5e-2
GPTQ_RATIO_TOL = 0.2
GPTQ_GAIN = 2.0


def site_kind(key: str) -> str:
    """``layers.{i}.{site}`` -> the site's kind (the experts' as one)."""
    return re.sub(r"^e\d+\.", "experts.", key.split(".", 2)[2])


def calibration_report(report) -> dict:
    """The summary of a calibration report and, per site kind, its sites,
    their formats, error ratios (mean, max) and int8 columns."""
    kinds = {}
    for key, rep in report.items():
        if key == "summary" or "format" not in rep:
            continue
        k = kinds.setdefault(site_kind(key), dict(
            sites=0, formats={}, err_ratio=[], int8_cols=set()))
        k["sites"] += 1
        k["formats"][rep["format"]] = k["formats"].get(rep["format"], 0) + 1
        k["err_ratio"].append(rep["err_ratio"])
        if "int8_cols" in rep:
            k["int8_cols"].add(rep["int8_cols"])
    for k in kinds.values():
        errs = k.pop("err_ratio")
        k["err_ratio_mean"] = sum(errs) / len(errs)
        k["err_ratio_max"] = max(errs)
        k["int8_cols"] = sorted(k["int8_cols"])
    return dict(summary=report["summary"], sites=kinds)


def calibration_launches(report, fmt: str) -> dict:
    """Launches of each kernel in a calibration's propagation forwards:
    one forward a block on the calibration batch through its quantized,
    still unfused linears (each member of a site once; a mixed format's
    base kernel and K1 each)."""
    out = {}
    for key, rep in report.items():
        if key == "summary" or "format" not in rep:
            continue
        members = SITE_MEMBERS.get(site_kind(key).split(".")[-1], 1)
        kernels = MIXED_KERNELS.get(rep["format"]) or (
            FORMAT_KERNEL[rep["format"]],)
        for k in kernels:
            out[k] = out.get(k, 0) + members
    return out


def gptq_against_cpu(device, path, vocab: int, sites=GPTQ_SITES, bits=2,
                     group=64) -> dict:
    """``gptq_quantize`` on the card against its plain version on the CPU,
    on the same weight and Hessian: layer 0's ``sites`` of the checkpoint
    at ``path``, its exact weights, and the Hessians its capture forward
    records from 4096 synthetic tokens (as calibration does). Held: the
    codes in range, the first half of the columns alike but for
    ``GPTQ_HALF_SHARE``, the H-weighted output error ratios within
    ``GPTQ_RATIO_TOL`` of each other and both below RTN's /
    ``GPTQ_GAIN``. Printed: seconds each, the share of codes (by eighths
    of the columns) and of scales that differ, the largest code
    difference."""
    from vptq_tpu_torch.models.loader import load_model
    from vptq_tpu_torch.quant import calibrate as cal
    from vptq_tpu_torch.quant.gptq import (
        dequant_groups,
        gptq_quantize,
        group_spans,
        output_error_ratio,
        true_f32,
    )

    cut = cut_checkpoint(path, 1)
    out = {}
    try:
        exact = load_model(str(cut), runtime_format="codebook", fuse=False,
                           device=device)
        ids = cal.synthetic_calibration_tokens(vocab).to(
            device=device, dtype=torch.int64)
        x, cos, sin, cache = cal._fresh_inputs(exact, ids)
        block = exact.blocks[0]
        with true_f32():
            _, hess = cal._capture_block(0, block, cal._site_map(block), x,
                                         cos, sin, cache, exact.cfg)
        del x, cache
        offset = 0.5 if bits == 2 else 0.0
        for site, p in sites:
            w = cal._exact_weight(block.get_submodule(p))
            h = hess[site].h
            _sync(device)
            t0 = time.perf_counter()
            q, sc = gptq_quantize(w, h, bits=bits, group=group)
            _sync(device)
            card_s = time.perf_counter() - t0
            w, h = w.cpu(), h.cpu()
            t0 = time.perf_counter()
            q_cpu, sc_cpu = gptq_quantize(w, h, bits=bits, group=group)
            cpu_s = time.perf_counter() - t0
            q, sc = q.cpu(), sc.cpu()
            spans = group_spans(w.shape[1], group)
            q0, s0 = gptq_quantize(w, None, bits=bits, group=group)
            err = {name: output_error_ratio(
                w, dequant_groups(a, b, spans, offset), h)
                for name, (a, b) in dict(card=(q, sc), cpu=(q_cpu, sc_cpu),
                                         rtn=(q0, s0)).items()}
            diff = (q.to(torch.int16) - q_cpu.to(torch.int16)).abs()
            n = diff.shape[1]
            res = dict(
                shape=list(w.shape), bits=bits, card_s=card_s, cpu_s=cpu_s,
                codes_differ=(diff > 0).float().mean().item(),
                codes_differ_by_eighth=[
                    (diff[:, i * n // 8:(i + 1) * n // 8] > 0).float()
                    .mean().item() for i in range(8)],
                codes_differ_first_half=(diff[:, :n // 2] > 0).float()
                .mean().item(),
                max_code_diff=int(diff.max()),
                scales_differ=(sc != sc_cpu).float().mean().item(),
                err_ratio=err,
            )
            print(f"gptq card vs cpu {site} " + json.dumps(res))
            qmin, qmax = {2: (-2, 1), 3: (-4, 3), 4: (-7, 7)}[bits]
            if not (qmin <= int(q.min()) and int(q.max()) <= qmax
                    and res["codes_differ_first_half"] <= GPTQ_HALF_SHARE
                    and abs(err["card"] - err["cpu"])
                    <= GPTQ_RATIO_TOL * err["cpu"]
                    and max(err["card"], err["cpu"]) * GPTQ_GAIN
                    < err["rtn"]):
                raise AssertionError(f"gptq {site}: card against cpu {res}")
            out[site] = res
    finally:
        shutil.rmtree(cut, ignore_errors=True)
    return out


def held_propagation(fmt: str, forward, held: list):
    """``calibrate._block_forward`` that holds every kernel call of each
    propagation forward (a quantized block, unfused, on the f32
    calibration batch: x of 8 x 512 tokens and an f32 out, a mixed
    layer's side on its gathered columns, each expert of a MoE block on
    every token) against the kernel's plain version on the same inputs:
    |err| <= RTOL * |plain| + ATOL_FRAC * max|plain|. A capture forward
    (exact mirrors, no kernel) passes through. Each call's numbers go to
    ``held``; the plain calls launch nothing. (The block's output is not
    the yardstick: at these activations a product's last bits can tip an
    attention row, so it moves far more than any kernel's error.)"""
    from vptq_tpu_torch.layers import runtime
    from vptq_tpu_torch.quant import calibrate as cal

    def checking(i, name, kernel):
        ref = kernel_fns(name)[1]

        def call(x, *args):
            y = kernel(x, *args)
            yf, rf = y.float(), ref(x, *args).float()
            err = (yf - rf).abs()
            limit = RTOL * rf.abs() + ATOL_FRAC * rf.abs().max()
            held.append(dict(
                block=i, kernel=name, x=list(x.shape),
                dtype=str(x.dtype).removeprefix("torch."),
                max_abs_err=err.max().item(),
                of_limit=(err / limit).nan_to_num(0.0).max().item(),
            ))
            if not (y.dtype == x.dtype and bool(torch.all(err <= limit))
                    and bool(torch.isfinite(yf).all())):
                raise AssertionError(
                    f"{fmt}: {name} in the propagation of block {i} "
                    f"against its plain version: {held[-1]}")
            return y

        return call

    def checked(i, block, x, cos, sin, cache, cfg):
        if any(isinstance(m, cal._Rec) for m in block.modules()):
            return forward(i, block, x, cos, sin, cache, cfg)
        with contextlib.ExitStack() as stack:
            for name in format_kernels(fmt):
                stack.enter_context(mock.patch.object(
                    runtime, name, checking(i, name, getattr(runtime, name))))
            return forward(i, block, x, cos, sin, cache, cfg)

    return checked


def phase_calibrated(device, path, fmt: str, vocab: int, calibration=None,
                     gptq=False, **e2e_kwargs):
    """GPTQ calibration (M15) on the card, then the calibrated model
    served: ``from_pretrained(path, runtime_format=fmt)`` (4096 synthetic
    tokens) or, for a plain format, ``load_model(path, runtime_format=fmt,
    calibration=calibration)``. Printed: the report (a spy on
    ``quantize_model_calibrated``): its summary with the seconds of the
    ranking pass, the capture, GPTQ and the propagation in all and per
    block; per site kind the formats, error ratios and int8 columns; the
    int8 sites of int4-mixed; the load's seconds and peak memory; the
    launches of the propagation forwards, which must be
    :func:`calibration_launches`, each held against its plain version
    (:func:`held_propagation`). Then written by ``export_runtime`` to a
    temporary directory (removed afterwards), read back by
    ``load_runtime_model`` and held byte-equal, and served by
    :func:`phase_e2e` from what was read, with ``sensitivity=True``.
    ``gptq``: first :func:`gptq_against_cpu` on layer 0's sites."""
    from vptq_tpu_torch import AutoModelForCausalLM
    from vptq_tpu_torch.models.loader import load_model
    from vptq_tpu_torch.quant import calibrate as cal
    from vptq_tpu_torch.tools.export_runtime import (
        export_runtime,
        load_runtime_model,
    )

    made = {}
    if gptq:
        made["gptq_against_cpu"] = gptq_against_cpu(device, path, vocab)
    reports = []
    real = cal.quantize_model_calibrated

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        reports.append(out[1])
        return out

    cuda = torch.device(device).type == "cuda"
    fns = {k: kernel_fns(k)[0] for k in ALL_KERNELS}
    for f in fns.values():
        f.launches = 0
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    held = []
    t0 = time.perf_counter()
    with mock.patch.object(cal, "quantize_model_calibrated", spy), \
            mock.patch.object(cal, "_block_forward", held_propagation(
                fmt, cal._block_forward, held)):
        if calibration is None:
            model = AutoModelForCausalLM.from_pretrained(
                path, runtime_format=fmt, device=device).model
        else:
            model = load_model(path, runtime_format=fmt,
                               calibration=calibration, device=device)
    _sync(device)
    load_s = time.perf_counter() - t0
    report = reports[0]
    counts = {k: f.launches for k, f in fns.items() if f.launches}
    # the CPU runs the plain versions, which count nothing
    expected = calibration_launches(report, fmt) if cuda else {}
    if counts != expected:
        raise AssertionError(
            f"{fmt}: calibration launches {counts}, expected {expected}")
    made.update(
        load_s=load_s, weights_gb=buffer_bytes(model) / 1e9,
        peak_gb=(torch.cuda.max_memory_allocated(device) / 1e9 if cuda
                 else None),
        calibration_launches=counts, **calibration_report(report),
        propagation_vs_plain=dict(
            calls={k: sum(h["kernel"] == k for h in held)
                   for k in sorted({h["kernel"] for h in held})},
            x=sorted({f"{tuple(h['x'])} {h['dtype']}" for h in held}),
            max_abs_err=max(h["max_abs_err"] for h in held),
            of_limit=max(h["of_limit"] for h in held),
        ),
    )
    if cuda and made["propagation_vs_plain"]["calls"] != counts:
        raise AssertionError(
            f"{fmt}: held {made['propagation_vs_plain']['calls']} of the "
            f"propagation's launches {counts}")
    if fmt == "int4-mixed":
        made["int8_sites"] = sorted(
            k for k, v in report.items() if v.get("format") == "int8")
    print(f"calibration {fmt} " + json.dumps(made))
    out = tempfile.mkdtemp(prefix="vptq_cal_")
    try:
        made["disk"] = disk_room(out, fmt, buffer_bytes(model))
        t0 = time.perf_counter()
        export_runtime(model, out)
        made["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_runtime_model(out, device)
        _sync(device)
        made["runtime_load_s"] = time.perf_counter() - t0
        made["bytes_equal_gb"] = same_buffers(model, loaded, fmt) / 1e9
        print(f"calibrated runtime checkpoint {fmt} " + json.dumps(
            {k: made[k] for k in ("write_s", "runtime_load_s",
                                  "bytes_equal_gb")}))
        del model
        result = phase_e2e(device, loaded, fmt, vocab, load_s=load_s,
                           sensitivity=True, **e2e_kwargs)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    result["calibration"] = made
    return result


# --------------------------------------------------------------------
# The user entry points (M12's CLI and web app, M13's eval)
# --------------------------------------------------------------------


def _byte_level_bytes() -> list:
    """The byte of each of the ids 3..258 of ``utils/synth_tokenizer.py``'s
    directory: its vocabulary lists the ``ByteLevel`` alphabet (GPT-2's
    byte-to-character table) sorted by character."""
    printable = [*range(ord("!"), ord("~") + 1),
                 *range(ord("¡"), ord("¬") + 1),
                 *range(ord("®"), ord("ÿ") + 1)]
    char = {b: b for b in printable}
    for n, b in enumerate(b for b in range(256) if b not in char):
        char[b] = 256 + n
    return sorted(range(256), key=char.__getitem__)


class ByteTokenizer:
    """The byte tokenizer of ``utils/synth_tokenizer.py``'s directory
    without ``transformers``, which the card's machine lacks: ids 0-2
    ``<pad>``, ``<s>``, ``</s>`` (the EOS), each UTF-8 byte of the text at
    its id from 3 on, no special tokens added, its chat template. Ids from
    259 on decode to nothing. The smoke's checks are on ids."""

    eos_token_id = 2

    def __init__(self):
        self.byte_of = _byte_level_bytes()
        self.id_of = {b: 3 + i for i, b in enumerate(self.byte_of)}

    def encode(self, text: str) -> list:
        return [self.id_of[b] for b in text.encode("utf-8")]

    def __call__(self, text, return_tensors=None, add_special_tokens=True):
        return {"input_ids": self.encode(text)}

    def decode(self, ids, skip_special_tokens=True) -> str:
        """The text of ``ids``, the specials skipped (as the entry points
        ask)."""
        return bytes(self.byte_of[i - 3] for i in ids if 3 <= i < 259
                     ).decode("utf-8", errors="replace")

    def apply_chat_template(self, messages, add_generation_prompt=True):
        text = "".join(f"{m['role']}: {m['content']}\n" for m in messages)
        return self.encode(
            text + ("assistant:" if add_generation_prompt else ""))


class Recorder:
    """A generator as the entry points call it, recording each
    ``generate``: its prompt, the ids its stream callback got, the ids it
    returned, TTFT and decode tok/s (host clock; the ids are read back
    before ``generate`` returns). It holds ids and times only, so dropping
    it drops the generator it wraps."""

    def __init__(self, gen, calls: list):
        self.gen, self.calls, self.device = gen, calls, gen.device

    def generate(self, prompt, stream_callback=None, **kwargs):
        streamed, stamps = [], []

        def stream(tok):
            stamps.append(time.perf_counter())
            streamed.append(int(tok))
            if stream_callback is not None:
                stream_callback(tok)

        t0 = time.perf_counter()
        out = self.gen.generate(prompt, stream_callback=stream, **kwargs)
        t1 = time.perf_counter()
        self.calls.append(dict(
            prompt=[int(t) for t in prompt], streamed=streamed,
            returned=list(out), ttft_s=stamps[0] - t0,
            decode_tok_s=(len(out) - 1) / max(t1 - stamps[0], 1e-9),
        ))
        return out


def _call_summary(call) -> dict:
    return dict(prompt=len(call["prompt"]), new=len(call["returned"]),
                ttft_s=call["ttft_s"], decode_tok_s=call["decode_tok_s"])


def _http(base, path, obj=None):
    """GET (``obj`` None) or POST JSON; the response object."""
    import urllib.request

    data = None if obj is None else json.dumps(obj).encode()
    return urllib.request.urlopen(urllib.request.Request(
        base + path, data=data, headers={"Content-Type": "application/json"},
    ), timeout=600)


def _sse_events(resp) -> list:
    return [json.loads(line[len("data: "):])
            for line in resp.read().decode().split("\n\n")
            if line.startswith("data: ")]


def _stats_after(base, t: float, timeout: float = 10.0) -> dict:
    """The memory series once it holds a sample taken after host time
    ``t``."""
    t_end = time.time() + timeout
    while True:
        stats = json.loads(_http(base, "/api/stats").read())
        if stats["time"] and stats["time"][-1] > t:
            return stats
        if time.time() > t_end:
            raise AssertionError("the memory poll took no sample")
        time.sleep(0.1)


def _qa_records(rng, n_items: int, context: tuple) -> list:
    """ARC-Easy records of 4 choices whose questions run evenly from
    ``context[0]`` to ``context[1]`` bytes: the byte tokenizer's pairs
    fill buckets 32 to 256 at the smoke's (1, 200)."""
    words = ["alpha", "beta", "gamma", "delta", "stone", "river", "light",
             "seven", "north", "cloud", "sugar", "metal", "paper", "quiet"]
    out = []
    for i, n in enumerate(np.linspace(*context, n_items).astype(int)):
        question = " ".join(rng.choice(words, size=n // 6 + 1))[:n]
        # the first item's one-word choices keep its pairs in bucket 32
        choices = [" ".join(rng.choice(words, size=1 if i == 0 else int(k)))
                   for k in rng.integers(1, 4, 4)]
        out.append(dict(question=question,
                        choices=dict(text=choices, label=list("ABCD")),
                        answerKey="ABCD"[i % 4]))
    return out


# the run whose checkpoint the entry points are driven on (full width, all
# 32 layers)
ENTRY_RUN = "Llama-3.1-8B"
# a window's mean NLL through the kernels against the plain versions, nats
PPL_NLL_TOL = 1e-2
# a window's summed NLL against F.cross_entropy on its own logits
PPL_CE_RTOL = 1e-5
# one pair's summed log-likelihood through the kernels against the plain
# versions: |ll - ll_plain| <= QA_RTOL * |ll_plain| + QA_ATOL
QA_RTOL, QA_ATOL = 1e-3, 1e-2
# a layer's diagnostics recomputed from CPU copies against the card's
DIAG_RTOL = 1e-5


def phase_entry_points(device, path, vocab: int, seed=0, prompt_len=128,
                       new_tokens=32, max_seq=4096, ppl_seq=4096,
                       ppl_windows=2, qa_items=32, qa_context=(1, 200)):
    """The entry points a user runs (``python -m vptq_tpu_torch``, the web
    app, ``eval.ppl``, ``eval.qa``, the diagnostics) on the checkpoint at
    ``path``, with :class:`ByteTokenizer`:

    1. CLI: ``cli._load`` (int8, ``max_seq``, greedy), ``eval_prompt`` on a
       ``prompt_len``-token prompt and ``chat_loop`` over ``hello``,
       ``clear``, an empty line, a second message and ``exit``; every
       call's streamed ids are its returned ids and the eager loop's
       (:func:`eager_tokens`); launches exact; ``--tp 2`` refused naming
       M16.
    2. Perplexity over ``ppl_windows`` windows of ``ppl_seq`` byte ids
       from ``seed``: launches exact (K1 four a layer, K8 one a layer at
       1024 tokens or more, a window); the mean NLL within PPL_NLL_TOL of
       the plain versions' (``plain_versions``: K1 and K8 swapped); a
       window's NLL within PPL_CE_RTOL of ``F.cross_entropy`` on its own
       logits; on the card K1's and K8's busy ms in one window.
    3. QA: an ARC-Easy file of ``qa_items`` items (4 choices) through
       ``qa.main`` with ``--tokenizer byte`` (its own int8 load; launches
       exact), then ``loglikelihoods`` on the same pairs through the
       kernels and through the plain versions, each pair within
       QA_RTOL · |plain| + QA_ATOL.
    4. Web app on a thread, serving the CLI's generator, which the phase
       then drops: ``/``, ``/api/models``, ``/api/stats`` (on the card in
       use at least the int8 weights, the limit the card's memory), a
       greedy chat as JSON and as SSE (the deltas are the content, the
       ids equal), a switch to int4 (the int8 model freed: in use below
       both models' weights), a chat on K2, an unknown name (500; int4
       still answers).
    5. Diagnostics: ``model_reconstruction_report`` of the int8 (a third
       load) and the int4 model against the codebook model (``fuse=False``)
       over every linear, int4's worst relative RMS above int8's, the
       first and the last layer recomputed from CPU copies within
       DIAG_RTOL.

    Returns ``launches`` (the counted runs) and the phase's numbers."""
    import copy
    import io
    import threading
    import types
    import urllib.error

    import torch.nn.functional as F

    from vptq_tpu_torch.eval import ppl as ppl_mod
    from vptq_tpu_torch.eval import qa
    from vptq_tpu_torch.eval.diagnostics import (
        model_reconstruction_report,
        summarize_report,
    )
    from vptq_tpu_torch.models.llama import forward
    from vptq_tpu_torch.models.loader import load_model
    from vptq_tpu_torch.serving import cli, webapp
    from vptq_tpu_torch.serving.generate import Generator

    fns = {k: kernel_fns(k)[0] for k in ALL_KERNELS}
    cuda = torch.device(device).type == "cuda"
    launches = dict.fromkeys(ALL_KERNELS, 0)
    result = {}
    tok = ByteTokenizer()
    rng = np.random.default_rng(seed)

    def counted(run, expected_of):
        """``run()`` with every count set to 0 first; the counts after it
        must be ``expected_of(its result)`` (zeros off the card); they add
        to the phase's."""
        for f in fns.values():
            f.launches = 0
        out = run()
        _sync(device)
        counts = {k: f.launches for k, f in fns.items()}
        expected = dict.fromkeys(ALL_KERNELS, 0)
        if cuda:
            expected.update(expected_of(out))
        if counts != expected:
            raise AssertionError(f"launches {counts}, expected {expected}")
        for k in launches:
            launches[k] += counts[k]
        return out

    def requests_launches(calls, fmt="int8"):
        out = dict.fromkeys(ALL_KERNELS, 0)
        for call in calls:
            for k, n in expected_launches(
                    cfg, fmt, len(call["prompt"]), len(call["returned"]),
                    buckets).items():
                out[k] += n
        return out

    # 1. the CLI
    argv = ["--model", path, "--runtime-format", "int8", "--max-seq",
            str(max_seq), "--temperature", "0", "--max-new-tokens",
            str(new_tokens), "--device", str(device)]
    args = cli.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    model, gen = cli._load(args)
    _sync(device)
    cli_out = dict(load_s=time.perf_counter() - t0)
    cfg, buckets = model.cfg, gen.prompt_buckets
    try:
        cli._load(cli.build_parser().parse_args([*argv, "--tp", "2"]))
        raise AssertionError("--tp 2 was not refused")
    except SystemExit as e:
        if "M16" not in str(e):
            raise AssertionError(f"--tp 2 refused without M16: {e}") from e
    calls = []
    rec = Recorder(gen, calls)
    args.prompt = "".join(map(chr, rng.integers(32, 127, prompt_len)))
    second = "and what of the " + " ".join(["river"] * 6) + "?"
    stdin = io.StringIO(f"hello\nclear\n\n{second}\nexit\n")
    shown = io.StringIO()
    with contextlib.redirect_stdout(shown), \
            contextlib.redirect_stderr(io.StringIO()), \
            mock.patch("sys.stdin", stdin):
        counted(lambda: cli.eval_prompt(rec, tok, args),
                lambda _: requests_launches(calls[-1:]))
        counted(lambda: cli.chat_loop(rec, tok, args),
                lambda _: requests_launches(calls[1:]))
    want_prompts = [
        tok(args.prompt)["input_ids"],
        tok.apply_chat_template([{"role": "user", "content": "hello"}]),
        tok.apply_chat_template([{"role": "user", "content": second}]),
    ]
    if [c["prompt"] for c in calls] != want_prompts:
        raise AssertionError("the CLI sent other prompts")
    if len(want_prompts[0]) != prompt_len or not (
            shown.getvalue().startswith(args.prompt)
            and shown.getvalue().count("Assistant: ") == 2):
        raise AssertionError("the CLI's output lacks the prompt or a turn")
    for call in calls:
        if call["streamed"] != call["returned"]:
            raise AssertionError("CLI: streamed ids differ from returned")
        if eager_tokens(model, gen, call["prompt"],
                        len(call["returned"])) != call["returned"]:
            raise AssertionError("CLI: ids differ from the eager loop's")
    cli_out["requests"] = [_call_summary(c) for c in calls]
    result["cli"] = cli_out
    print("entry cli " + json.dumps(cli_out), flush=True)

    # 2. perplexity
    ids = rng.integers(3, 259, ppl_seq * ppl_windows)
    t0 = time.perf_counter()
    ppl = counted(
        lambda: ppl_mod.perplexity(model, ids, seq_len=ppl_seq),
        lambda _: launches_of(cfg, "int8", [(1, ppl_seq, True)] * ppl_windows))
    ppl_s = time.perf_counter() - t0
    with plain_versions("int8"):
        ppl_plain = ppl_mod.perplexity(model, ids, seq_len=ppl_seq)
    nll_gap = abs(np.log(ppl) - np.log(ppl_plain))
    if not nll_gap <= PPL_NLL_TOL:
        raise AssertionError(f"ppl {ppl} vs plain {ppl_plain}")
    window = torch.from_numpy(ids[:ppl_seq])[None].to(device)
    seen = []

    def spy(*a, **kw):
        out = forward(*a, **kw)
        seen.append(out[0])
        return out

    with mock.patch.object(ppl_mod, "forward", spy):
        nll, count = ppl_mod.window_nll(model, window)
    with torch.inference_mode():
        ce = F.cross_entropy(seen[0][0, :-1], window[0, 1:],
                             reduction="sum").item()
    del seen
    if not abs(nll - ce) <= PPL_CE_RTOL * abs(ce):
        raise AssertionError(f"window NLL {nll} vs cross entropy {ce}")
    ppl_out = dict(
        ppl=ppl, ppl_plain=ppl_plain, mean_nll_gap=float(nll_gap),
        window_nll=nll, cross_entropy=ce, windows=ppl_windows,
        seq_len=ppl_seq, s_per_window=ppl_s / ppl_windows,
        tok_s=ppl_seq * ppl_windows / ppl_s,
    )
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        ppl_mod.window_nll(model, window)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ppl_mod.window_nll(model, window)
        events = _device_events(prof)
        on_path = ["w8_matmul"] + (
            [FLASH] if launches_of(cfg, "int8", [(1, ppl_seq, True)])[FLASH]
            else [])
        ppl_out["window_busy_ms"] = sum(
            e.device_time_total for e in events) / 1e3
        ppl_out["kernel_ms"] = _kernel_ms(
            events, {k: fns[k].trace_tags for k in on_path}, "ppl window")
    result["ppl"] = ppl_out
    print("entry ppl " + json.dumps(ppl_out), flush=True)

    # 3. QA
    qa_dir = Path(tempfile.mkdtemp(prefix="vptq_smoke_qa_"))
    try:
        data = qa_dir / "arc_easy.jsonl"
        data.write_text("".join(json.dumps(r) + "\n" for r in _qa_records(
            rng, qa_items, qa_context)))
        items = qa.load_task("arc_easy", str(data))
        pairs, _ = qa._pairs(items, qa._byte_tokenizer)
        batches = [S for S, _ in qa._batches(qa._prepared(pairs, 2048), 8)]
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = counted(lambda: qa.main([
                "--model", path, "--task", "arc_easy", "--data", str(data),
                "--tokenizer", "byte", "--device", str(device)]),
                lambda _: launches_of(cfg, "int8",
                                      [(8, S, True) for S in batches]))
        qa_main_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(qa_dir, ignore_errors=True)
    headline = printed.getvalue().splitlines()[-2]
    if rc != 0 or not headline.startswith("arc_easy: acc"):
        raise AssertionError(f"qa.main: {rc} {headline}")
    t0 = time.perf_counter()
    got = qa.loglikelihoods(model, pairs)
    qa_s = time.perf_counter() - t0
    with plain_versions("int8"):
        want = qa.loglikelihoods(model, pairs)
    gaps = np.abs(got - want) / (QA_RTOL * np.abs(want) + QA_ATOL)
    if not (np.isfinite(got).all() and gaps.max() <= 1.0):
        raise AssertionError(f"QA: a pair off the plain versions ({gaps})")
    qa_out = dict(items=len(items), pairs=len(pairs),
                  buckets=sorted(set(batches)), calls=len(batches),
                  headline=headline, main_s=qa_main_s, scoring_s=qa_s,
                  items_per_s=len(items) / qa_s,
                  worst_of_bound=float(gaps.max()))
    result["qa"] = qa_out
    print("entry qa " + json.dumps(qa_out), flush=True)

    # 4. the web app, serving the CLI's generator; the phase drops its own
    # references, so that the switch frees the int8 model
    int8_bytes = buffer_bytes(model)
    web_calls = []

    def load_fn(value):
        where, fmt = value
        m = load_model(where, dtype=torch.bfloat16, runtime_format=fmt,
                       device=device)
        return Recorder(Generator(m, max_seq=max_seq), web_calls), None

    httpd = webapp.serve(
        Recorder(gen, web_calls), tok, port=0,
        gen_args={"max_new_tokens": new_tokens, "temperature": 0.0},
        models={"int8": (path, "int8"), "int4": (path, "int4")},
        current="int8", load_fn=load_fn,
    )
    del rec, gen, model
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    web = {}
    try:
        page = _http(base, "/").read().decode()
        models = json.loads(_http(base, "/api/models").read())
        if "GPU memory" not in page or models != {
                "models": ["int8", "int4"], "current": "int8"}:
            raise AssertionError(f"web app: page or models {models}")
        stats = _stats_after(base, 0.0)
        web["int8_in_use_gb"] = stats["bytes_in_use"][-1] / 1e9
        web["limit_gb"] = stats["bytes_limit"][-1] / 1e9
        if cuda and not (
                stats["bytes_in_use"][-1] >= int8_bytes
                and stats["bytes_limit"][-1] == torch.cuda
                .get_device_properties(device).total_memory):
            raise AssertionError(f"web app stats {stats}")
        msgs = [{"role": "user", "content": "tell me a story"}]
        reply = counted(
            lambda: json.loads(_http(base, "/api/chat",
                                     {"messages": msgs}).read()),
            lambda _: requests_launches(web_calls[-1:]))
        events = counted(
            lambda: _sse_events(_http(base, "/api/chat",
                                      {"messages": msgs, "stream": True})),
            lambda _: requests_launches(web_calls[-1:]))
        done = events[-1]
        if not (done.get("done") and done["content"] == reply["content"]
                and "".join(e["delta"] for e in events[:-1])
                == done["content"]
                and web_calls[0]["returned"] == web_calls[1]["returned"]
                and all(c["streamed"] == c["returned"] for c in web_calls)
                and done["tokens_per_s"] > 0 and reply["tokens_per_s"] > 0):
            raise AssertionError(f"web app chat: {reply} / {done}")
        web["chat_int8"] = _call_summary(web_calls[1])
        web["sse_tok_s"] = done["tokens_per_s"]
        t0 = time.perf_counter()
        switched = json.loads(_http(base, "/api/model",
                                    {"name": "int4"}).read())
        _sync(device)
        web["switch_s"] = time.perf_counter() - t0
        t_switched = time.time()
        int4_bytes = buffer_bytes(httpd.state.generator.gen.model)
        stats = _stats_after(base, t_switched)
        web["int4_in_use_gb"] = stats["bytes_in_use"][-1] / 1e9
        if switched != {"current": "int4"} or (
                cuda and stats["bytes_in_use"][-1] >= int8_bytes + int4_bytes):
            raise AssertionError(
                f"switch {switched}: in use {stats['bytes_in_use'][-1]}, "
                f"weights {int8_bytes} + {int4_bytes}")
        reply4 = counted(
            lambda: json.loads(_http(base, "/api/chat",
                                     {"messages": msgs}).read()),
            lambda _: requests_launches(web_calls[-1:], "int4"))
        if cuda and launches["w4_matmul"] <= 0:
            raise AssertionError("the int4 chat launched no K2")
        web["chat_int4"] = _call_summary(web_calls[-1])
        try:
            _http(base, "/api/model", {"name": "int3-from-nowhere"})
            raise AssertionError("an unknown model was switched to")
        except urllib.error.HTTPError as e:
            if e.code != 500:
                raise
        again = counted(
            lambda: json.loads(_http(base, "/api/chat",
                                     {"messages": msgs}).read()),
            lambda _: requests_launches(web_calls[-1:], "int4"))
        if (again["content"] != reply4["content"]
                or httpd.state.current != "int4"):
            raise AssertionError("the int4 model did not survive a bad name")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
    result["web"] = web
    print("entry web " + json.dumps(web), flush=True)

    # 5. diagnostics: the int4 model the web app switched to, the int8
    # model loaded once more, both against the codebook model
    int4_model = httpd.state.generator.gen.model
    del httpd
    t0 = time.perf_counter()
    reference = load_model(path, dtype=torch.bfloat16,
                           runtime_format="codebook", fuse=False,
                           device=device)
    int8_model = load_model(path, dtype=torch.bfloat16,
                            runtime_format="int8", device=device)
    _sync(device)
    diag = dict(load_s=time.perf_counter() - t0)
    last = cfg.num_hidden_layers - 1
    cpu_ref = {i: copy.deepcopy(reference.blocks[i]).cpu()
               for i in (0, last)}
    for fmt, m in (("int8", int8_model), ("int4", int4_model)):
        t0 = time.perf_counter()
        report = model_reconstruction_report(m, reference)
        _sync(device)
        seconds = time.perf_counter() - t0
        summary = summarize_report(report)
        if summary["n_layers"] != 4 * cfg.num_hidden_layers + 1:
            raise AssertionError(f"diagnostics {fmt}: {summary}")
        worst = 0.0
        for i in (0, last):
            here = model_reconstruction_report(
                types.SimpleNamespace(
                    blocks=[copy.deepcopy(m.blocks[i]).cpu()],
                    lm_head=None),
                types.SimpleNamespace(blocks=[cpu_ref[i]], lm_head=None))
            for name, r in here.items():
                card = report[name.replace("layers.0.", f"layers.{i}.", 1)]
                for k in ("rel_rms", "max_abs_err", "ref_rms"):
                    gap = abs(r[k] - card[k]) / max(abs(card[k]), 1e-30)
                    worst = max(worst, gap)
        if not worst <= DIAG_RTOL:
            raise AssertionError(f"diagnostics {fmt}: CPU recompute {worst}")
        diag[fmt] = dict(summary, seconds=seconds, cpu_recompute_gap=worst)
    if not diag["int4"]["worst_rel_rms"] > diag["int8"]["worst_rel_rms"]:
        raise AssertionError(f"diagnostics: int4 not above int8 {diag}")
    result["diagnostics"] = diag
    print("entry diagnostics " + json.dumps(diag), flush=True)
    del int4_model, int8_model, reference, cpu_ref
    if cuda:
        torch.cuda.empty_cache()
    result["launches"] = {k: n for k, n in launches.items() if n}
    return dict(entry_points=result, launches=launches)


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
    parts; MLA's q, kv_a, o and a DeepSeek block's shared experts; a
    mixed layer's base, then its side), and a MoE block's two pairs calls
    (gate_up, down)."""
    from vptq_tpu_torch.models.llama import (
        DeepseekMoe,
        MlaAttention,
        MoeMlp,
    )

    def call(lin):
        # a mixed layer: its base, then its int8 side on the gathered columns
        parts = (lin.base, lin.int8) if hasattr(lin, "col_idx") else (lin,)
        return [(LAYER_KERNEL[type(part).__name__], part.out_features,
                 part.in_padded) for part in parts]

    def mlp_linears(mlp):
        return ([mlp.gate_up_proj] if mlp.gate_up_proj is not None
                else [mlp.gate_proj, mlp.up_proj]) + [mlp.down_proj]

    out = []
    for block in model.blocks:
        attn, mlp = block.attn, block.mlp
        if isinstance(attn, MlaAttention):
            lins = [m for m in (attn.q_proj, attn.q_a_proj, attn.q_b_proj,
                                attn.kv_a_proj, attn.o_proj) if m is not None]
        else:
            lins = ([attn.qkv_proj] if attn.qkv_proj is not None
                    else [attn.q_proj, attn.k_proj, attn.v_proj]
                    ) + [attn.o_proj]
        if isinstance(mlp, (MoeMlp, DeepseekMoe)):
            st = mlp.stacked
            pairs = MOE_KERNELS[fmt][1]
            shared = (mlp_linears(mlp.shared_experts)
                      if isinstance(mlp, DeepseekMoe) else [])
            out += sum((call(lin) for lin in lins), []) + [
                (pairs, st.gate_up_wq.shape[1], None),
                (pairs, st.down_wq.shape[1], None),
            ] + sum((call(lin) for lin in shared), [])
            continue
        out += sum((call(lin) for lin in lins + mlp_linears(mlp)), [])
    return out


def linear_launches(model, fmt: str) -> dict:
    """{kernel: launches a forward call} of ``model``'s decoder linears (a
    mixed layer's base and side once each), from its layers' types; a MoE
    block's expert kernels aside."""
    out = dict.fromkeys(format_kernels(fmt), 0)
    pairs = MOE_KERNELS.get(fmt, (None, None))[1]
    for kernel, _, _ in decode_calls(model, fmt):
        if kernel != pairs:
            out[kernel] = out.get(kernel, 0) + 1
    return out


def step_routes(events, model, fmt: str, what: str, tokens: int = 1) -> dict:
    """The route check of one decode step's trace at ``tokens`` tokens (1,
    or a batched step's slots): each kernel's CUDA kernels fall in the
    families its wrapper routes that many tokens to (K2, K3, K5b: the
    decode GEMV, ``decode_gemv`` with ``Whole`` or ``Pairs``; K1 and K4:
    their ``takes_decode_gemv`` per linear; the rest their only family),
    every such family present and no other. Returns {kernel: families
    seen}."""
    want = {}
    for kernel, out_f, in_p in decode_calls(model, fmt):
        families = tag_sets(kernel_fns(kernel)[0].trace_tags)
        decode = [t for t in families if "decode_gemv" in t]
        rule = getattr(importlib.import_module(
            f"vptq_tpu_torch.ops.{kernel}"), "takes_decode_gemv", None)
        if decode and (rule is None or rule(tokens, out_f, in_p)):
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

    t_start = time.perf_counter()
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
    t_kernels = time.perf_counter()
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
    # K1 and K2 at 8 tokens: the decode GEMV's N = 8 instance (K1's
    # w8_gemv takes T = 1); K2's is the served step of the 8 slots
    for name in ("w8_matmul", "w4_matmul"):
        rows += phase_kernel(
            name, device, k1_shapes(LLAMA31_8B), (8,), in_record=False,
            routes=routes,
        )
    # K2 at the largest batched admission the serving phases can send:
    # admit_parallel rows of the longest bucket (K6b below as well)
    admit = SERVE["admit_parallel"] * max(SERVE["prompt_buckets"])
    rows += phase_kernel(
        "w4_matmul", device, k1_shapes(LLAMA31_8B), (admit,), iters=5,
        in_record=False,
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
    # K1 at the int8 side matrices of the mixed formats at Llama-3.1-8B
    # width: group 128, in_p 128 to 512 (one to four stages)
    sides = dict.fromkeys(
        s for fmt in MIXED_KERNELS for s in side_shapes(LLAMA31_8B, fmt))
    rows += phase_kernel(
        "w8_matmul", device, list(sides), SIDE_TOKENS, in_record=False,
        group=128, routes=routes,
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
            fmt, device, moe_shapes(MIXTRAL_8X7B),
            tokens=TOKENS + (admit,) if fmt == "int4" else TOKENS,
            pairs=(2, 16, 1, most) if fmt == "int4" else (2, 16),
            routes=routes,
        )
    # DeepSeek's shapes: K1 / K2 at Moonlight-16B-A3B's MLA (kv_a's out
    # 576 = 4.5 x 128), dense-layer and shared-expert linears; K5 / K6 at
    # its 64 experts (2048 <-> 1408, top 6: P = 6, 48 for 8 slots, 384 for
    # 64 tokens) and at DeepSeek-R1's 256 (7168 <-> 2048, top 8)
    for name in ("w8_matmul", "w4_matmul"):
        rows += phase_kernel(
            name, device, k1_shapes(MOONLIGHT_16B), DEEPSEEK_TOKENS,
            in_record=False, routes=routes,
        )
    top = MOONLIGHT_16B["num_experts_per_tok"]
    for fmt in MOE_KERNELS:
        rows += phase_moe_kernels(
            fmt, device, moe_shapes(MOONLIGHT_16B),
            n_experts=MOONLIGHT_16B["n_routed_experts"], top_k=top,
            pairs=(top, 8 * top, _MOE_FAST_MAX_TOKENS * top),
            routes=routes, in_record=False,
        )
        rows += phase_moe_kernels(
            fmt, device, moe_shapes(R1_EXPERTS),
            n_experts=R1_EXPERTS["n_routed_experts"],
            top_k=R1_EXPERTS["num_experts_per_tok"], tokens=(1, 128),
            pairs=(8, 64), routes=routes, in_record=False,
        )
    # every decode call in one profiler session, the process's first: a
    # second session, for the eight K5b calls alone, recorded seven
    # kernels, three times running (alone in a process it records eight)
    check_decode_routes(routes, device)
    del routes
    print(f"seconds kernel phases: {time.perf_counter() - t_kernels:.2f}")
    t0 = time.perf_counter()
    rows += phase_probes(device)
    print(f"probe phase: {time.perf_counter() - t0:.2f} s")
    with timed("encoders"):
        phase_encoders(device)
    launches = dict.fromkeys(ALL_KERNELS, 0)
    # (label, config, formats, what phase_e2e and the writer get beside,
    # the formats of the depth-cut runtime checkpoint round trip, the
    # formats served through the Scheduler and its phase's arguments, the
    # formats calibrated on the card from the checkpoint cut to a depth:
    # {format: (layers, calibration tokens)})
    runs = (
        ("Llama-3.1-8B", LLAMA31_8B, FORMAT_KERNEL, {}, {},
         ("int8", "int4"), {"int4": dict(per_len=4)}, {}),
        ("Mixtral-8x7B",
         dict(MIXTRAL_8X7B, num_hidden_layers=MIXTRAL_LAYERS), MOE_KERNELS,
         {}, {}, ("int4",), {"int4": dict(per_len=2)}, {}),
        # MLA, the grouped sigmoid MoE and its shared experts; MLA never
        # reaches K8. Calibrated int4 at two layers (the dense one and a
        # MoE one: 64 experts and the shared ones)
        ("Moonlight-16B-A3B",
         dict(MOONLIGHT_16B, num_hidden_layers=CUT_LAYERS), MOE_KERNELS, {},
         {}, (), {"int4": dict(per_len=2)}, {"int4": (2, 4096)}),
        ("Qwen2.5-7B", dict(QWEN25_7B, num_hidden_layers=CUT_LAYERS),
         ("int8",), {}, dict(qkv_bias=True), (), {}, {}),
        ("Mistral-7B", dict(MISTRAL_7B, num_hidden_layers=CUT_LAYERS),
         ("int8",), dict(prompt_lens=(16, 512, 1536, 4608), max_seq=8192),
         {}, (), {}, {}),
        # read from .bin shards and their index; the window keeps K8 at 0
        ("Phi-3-mini", dict(PHI3_MINI, num_hidden_layers=CUT_LAYERS),
         ("int8",),
         dict(prompt_lens=(16, 512, 1536, 3000), max_seq=4096),
         dict(bin_shards=4), (), {}, {}),
    )

    def count(e2e):
        served = e2e.get("serving", {}).get("launches", {})
        calibrated = e2e.get("calibration", {}).get(
            "calibration_launches", {})
        for name in launches:
            launches[name] += (e2e["launches"].get(name, 0)
                               + served.get(name, 0)
                               + calibrated.get(name, 0))

    for (label, cfg, formats, e2e_kwargs, writer_kwargs, trips, serve,
         calibrated) in runs:
        with timed(f"checkpoint write {label} "
                   f"({cfg['num_hidden_layers']} layers)"):
            path, _ = write_checkpoint(cfg, V8_K65536, **writer_kwargs)
        try:
            for fmt in formats:
                with timed(f"e2e {label} {fmt}"):
                    e2e = phase_e2e(
                        device, path, fmt, cfg["vocab_size"], **e2e_kwargs,
                        serve=serve.get(fmt),
                    )
                print(f"e2e {label} " + json.dumps(e2e))
                count(e2e)
            for fmt in trips:
                with timed(f"round trip {label} {fmt}"):
                    phase_round_trip(device, path, fmt, cfg["vocab_size"])
            if label == ENTRY_RUN:
                with timed("entry points"):
                    e2e = phase_entry_points(device, path, cfg["vocab_size"])
                print(f"e2e {label} entry points "
                      + json.dumps(e2e["entry_points"]))
                count(e2e)
            for fmt, (layers, tokens) in calibrated.items():
                cut = cut_checkpoint(path, layers)
                try:
                    with timed(f"calibrated {label} {fmt} ({layers} layers)"):
                        e2e = phase_calibrated(device, str(cut), fmt,
                                               cfg["vocab_size"], tokens)
                finally:
                    shutil.rmtree(cut, ignore_errors=True)
                print(f"e2e {label} calibrated " + json.dumps(e2e))
                count(e2e)
        finally:
            shutil.rmtree(path, ignore_errors=True)
    # the mixed formats from random codes, served from the port's own
    # runtime checkpoint at full width, depth cut to 4 (the calibrated run
    # below shows that path at all 32 layers)
    for fmt in MIXED_KERNELS:
        with timed(f"mixed {fmt} from random codes (4 layers)"):
            e2e = phase_mixed(device, dict(LLAMA31_8B, num_hidden_layers=4),
                              fmt)
        print("e2e Llama-3.1-8B " + json.dumps(e2e))
        count(e2e)
    # the calibrated formats (M15): GPTQ on the card at Llama-3.1-8B's full
    # width, int2-mixed at all 32 layers through from_pretrained (layer 0's
    # GPTQ held against the CPU's first), int3-mixed and int4-mixed at 4
    with timed("checkpoint write Llama-3.1-8B calibration (32 layers)"):
        path, _ = write_checkpoint(LLAMA31_8B, V8_K65536, std=MIXED_STD)
    vocab = LLAMA31_8B["vocab_size"]
    try:
        with timed("calibrated Llama-3.1-8B int2-mixed (32 layers)"):
            e2e = phase_calibrated(device, path, "int2-mixed", vocab,
                                   gptq=True)
        print("e2e Llama-3.1-8B calibrated " + json.dumps(e2e))
        count(e2e)
        cut = cut_checkpoint(path, 4)
        try:
            for fmt in ("int3-mixed", "int4-mixed"):
                with timed(f"calibrated Llama-3.1-8B {fmt} (4 layers)"):
                    e2e = phase_calibrated(device, str(cut), fmt, vocab)
                print("e2e Llama-3.1-8B calibrated " + json.dumps(e2e))
                count(e2e)
        finally:
            shutil.rmtree(cut, ignore_errors=True)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    print(f"seconds smoke: {time.perf_counter() - t_start:.2f}")
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
