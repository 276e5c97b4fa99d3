"""Serving planner: check a (model × format) deployment on one card BEFORE
any weight is read or re-encoded.

Port of ``vptq_tpu/tools/plan.py`` for one device. The reference answers
"will it fit?" only implicitly, through accelerate's ``max_memory``
heuristics at load time (reference: vptq/layers/model_base.py:165-181).
Here the model is built on ``torch.device("meta")`` with exactly the
shapes and dtypes of the runtime encoders (:func:`abstract_runtime_model`),
its budget is checked against the card's memory (``utils/memory.py``),
and one decode step of the port's ``forward`` runs on the meta tensors at
full geometry (:func:`validate_plan`), with zero weight bytes: a
DeepSeek-R1 671B plan costs no memory.

On meta tensors the kernels' plain versions run (a kernel needs real
memory), so the meta step checks the model's structure, shapes and dtypes
through the decode step, not the kernels. It covers every format's dense
path (int8, int4, int3, int2, bf16, codebook) and the stacked int8 / int4
experts' selected-experts (pairs) path that decode takes; nothing in it
reads a value on the host or builds a shape from data. The mixed formats
plan their base format (the per-column int8 sides are a calibration
output), as the JAX package does.

Over several devices (``--chips``, the total, over ``--hosts``): each
host's devices hold one replica, placed with the largest tensor-parallel
degree that divides them and passes ``tp.tp_validate`` (GQA geometries
cap it at their KV heads), pipeline stages taking the rest; the hosts
are data-parallel replicas. The budget is per device of a host, the
prediction per host (``predict_decode_tok_s`` over the TP degree, plus a
hop a stage boundary), and ``--compile`` runs one rank's decode step on
the meta device: the blocked model (:func:`abstract_runtime_model` with
``tp_shards``), its shard as ``tp.tp_place_model`` places it, the cache
as ``tp.shard_cache_tp`` cuts it, and ``forward(tp=)``, whose
collectives on meta tensors return their shapes and call no group
(``parallel/distributed.py``), as the JAX package compiles its sharded
step on a forced CPU mesh. With stages, one stage's layers. The
per-collective latency ``--ici-us`` (default 10 µs, the range printed
1–20 µs) is the JAX package's assumption, not a measurement: no
collective between cards has been timed for the port. The codebook
format over several devices plans under ``gspmd``, as the JAX package's
does: no pipeline stages, every weight over the whole host's devices
(``parallel/tp.py`` splits each VQ layer's index planes as JAX's GSPMD
placement does), and the meta step is one rank's of that placement.
``--parallel gspmd`` with another format stays refused: the JAX
package's spec-annotation placement of the kernel formats has no
counterpart (tensor parallelism is the port's sharded path).

CLI::

    python -m vptq_tpu_torch.tools.plan --geometry llama3-8b \
        --format int4 [--chips 8 [--hosts 2]] [--batch 1] [--max-seq 2048] \
        [--hbm-gb 80] [--compile]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import re
import sys
from typing import Dict, Optional

import torch

from vptq_tpu_torch.layers.dense import DenseLinear
from vptq_tpu_torch.layers.runtime import (
    Int2Linear,
    Int3Linear,
    Int4Linear,
    Int8Linear,
    blocked_pad,
    concat_blocked,
    pick_group,
)
from vptq_tpu_torch.models.llama import (
    Attention,
    Block,
    DeepseekMoe,
    MlaAttention,
    Mlp,
    Model,
    ModelConfig,
    MoeMlp,
    StackedExperts,
    forward,
    init_cache,
)
from vptq_tpu_torch.utils import memory as hbm
from vptq_tpu_torch.utils.profiling import H100_HBM_GBPS

__all__ = [
    "E2E_CARD",
    "E2E_GBPS",
    "GEOMETRIES",
    "abstract_runtime_model",
    "fit_e2e_rates",
    "parse_vq",
    "predict_decode_tok_s",
    "validate_plan",
]

# Published model geometries (per HF config.json of each family).
GEOMETRIES = {
    "llama2-7b": dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_hidden_layers=32, num_attention_heads=32,
        num_key_value_heads=32, head_dim=128,
    ),
    "llama2-13b": dict(
        vocab_size=32000, hidden_size=5120, intermediate_size=13824,
        num_hidden_layers=40, num_attention_heads=40,
        num_key_value_heads=40, head_dim=128,
    ),
    "llama2-70b": dict(
        vocab_size=32000, hidden_size=8192, intermediate_size=28672,
        num_hidden_layers=80, num_attention_heads=64,
        num_key_value_heads=8, head_dim=128,
    ),
    "llama3-8b": dict(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32,
        num_key_value_heads=8, head_dim=128,
    ),
    "llama3-70b": dict(
        vocab_size=128256, hidden_size=8192, intermediate_size=28672,
        num_hidden_layers=80, num_attention_heads=64,
        num_key_value_heads=8, head_dim=128,
    ),
    # meta-llama/Llama-3.1-405B config.json
    "llama3-405b": dict(
        vocab_size=128256, hidden_size=16384,
        intermediate_size=53248, num_hidden_layers=126,
        num_attention_heads=128, num_key_value_heads=8, head_dim=128,
    ),
    # mistralai/Mistral-Large-Instruct-2407 (123B) config.json
    "mistral-large-123b": dict(
        vocab_size=32768, hidden_size=12288,
        intermediate_size=28672, num_hidden_layers=88,
        num_attention_heads=96, num_key_value_heads=8, head_dim=128,
    ),
    "mixtral-8x7b": dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32,
        num_key_value_heads=8, head_dim=128,
        num_local_experts=8, num_experts_per_tok=2,
        model_type="mixtral",
    ),
    # deepseek-ai/DeepSeek-R1 config.json (671B MoE, MLA), the
    # reference's flagship deployment target (documents/deepseek.md)
    "deepseek-r1": dict(
        vocab_size=129280, hidden_size=7168,
        intermediate_size=18432, moe_intermediate_size=2048,
        num_hidden_layers=61, num_attention_heads=128,
        num_key_value_heads=128, head_dim=64,
        q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        n_routed_experts=256, num_experts_per_tok=8,
        n_shared_experts=1, first_k_dense_replace=3,
        n_group=8, topk_group=4, norm_topk_prob=True,
        routed_scaling_factor=2.5,
        model_type="deepseek_v3",
    ),
}

# End-to-end weight-stream rates (GB/s) of the batch-1 graphed decode
# step, fitted by fit_e2e_rates to chip_smoke.py's Llama-3.1-8B readings
# (32 layers, max_seq 2048, the lm_head in bf16) on E2E_CARD: total
# streamed bytes over the measured step, so the attention, norms and
# sampling are absorbed in proportion. bf16 has no reading of its own:
# the bf16 lm_head of those models streams at the int8 rate in the fit,
# and a bf16 model takes it too. The codebook format has no reading.
E2E_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
E2E_GBPS = {
    "int8": 1004.6,
    "int4": 497.5,
    "int3": 382.3,
    "int2": 302.1,
    "bf16": 1004.6,
}

# the mixed formats stream their base planes at the base rate and their
# int8 side matrices at the int8 rate (predict_decode_tok_s)
_MIXED_BASE = {"int3-mixed": "int3", "int2-mixed": "int2"}

# the per-collective latency of a plan over several devices: the JAX
# package's assumption (its ici_us), never measured between cards for the
# port, and the range the CLI prints around it
ICI_US = 10.0
ICI_US_RANGE = (20.0, 1.0)
# the spec-annotation placement of a runtime format over several devices
# is not ported
_GSPMD = ("the spec-annotation (GSPMD) placement of a runtime format has no "
          "counterpart in the port; plan --parallel tp (the codebook "
          "format plans under gspmd)")


def _stream_terms(cfg: ModelConfig, fmt: str, batch: int, max_seq: int,
                  quantize_lm_head: bool, tp_shards: int = 1
                  ) -> Dict[str, float]:
    """The bytes a decode step streams, by the rate they stream at: the
    blocks in the base format (MoE experts by the routed fraction
    ``min(1, batch * top_k / E)``) with the norms, the mixed formats'
    int8 sides, the lm_head, the KV cache read (half full on average).
    ``tp_shards``: the row-parallel layers blocked over that many."""
    base_fmt = _MIXED_BASE.get(fmt, fmt)
    est = hbm.estimate_model_bytes(
        cfg, base_fmt, quantize_lm_head=quantize_lm_head, tp_shards=tp_shards
    )
    L = cfg.num_hidden_layers
    n_exp = cfg.n_routed_experts or cfg.num_local_experts
    stream = est["blocks"]
    side = 0
    if fmt in _MIXED_BASE:
        side = hbm.estimate_model_bytes(
            cfg, fmt, quantize_lm_head=quantize_lm_head, tp_shards=tp_shards
        )["blocks"] - stream
    if n_exp:
        expert_bytes = sum(
            hbm.linear_runtime_bytes(
                g.out_features, g.in_features, base_fmt, None, 1
            ) * g.count
            for g in hbm.model_geometry(cfg)
            if g.count > L  # per-expert entries (count = layers * E)
        )
        frac = min(1.0, batch * cfg.num_experts_per_tok / n_exp)
        stream -= expert_bytes * (1.0 - frac)
    return dict(
        base=stream + est["norms"], side=side, lm_head=est["lm_head"],
        kv=hbm.kv_cache_bytes(cfg, batch, max_seq) / 2,
    )


def predict_decode_tok_s(
    cfg: ModelConfig,
    fmt: str,
    chips: int = 1,
    batch: int = 1,
    max_seq: int = 2048,
    quantize_lm_head: bool = True,
    ici_us: float = ICI_US,
    rates: Optional[Dict[str, float]] = None,
    hbm_gbps: float = H100_HBM_GBPS,
) -> float:
    """Predicted steady-state decode tok/s of one serving replica.

    The decode step is weight-stream bound, so the model is bytes over a
    measured rate (the JAX package's formula):

      t_step = blocks_bytes / chips / rates[fmt]
             + side_bytes / chips / rates["int8"]          (mixed formats)
             + lm_head_bytes / chips / rate(lm_head format)
             + kv_read_bytes / chips / HBM peak     (half full on average)
             + (2L + 1) * ici_us                           (chips > 1)

    ``rates``: GB/s per format, :data:`E2E_GBPS` (fitted on
    :data:`E2E_CARD`) by default. ``chips`` > 1: tensor parallelism over
    that many devices, the blocks' bytes in the blocked layout, and a
    collective term of two all-reduces a layer and the logits' gather,
    ``ici_us`` each: an assumption (:data:`ICI_US`, the JAX package's),
    not a measurement.
    """
    rates = E2E_GBPS if rates is None else rates
    base_fmt = _MIXED_BASE.get(fmt, fmt)
    if base_fmt not in rates:
        raise ValueError(f"no rate measured on the card for format {fmt!r}")
    tp = chips if chips > 1 else 1
    terms = _stream_terms(cfg, fmt, batch, max_seq, quantize_lm_head, tp)
    lm_rate = rates["int8" if quantize_lm_head else "bf16"]
    t = (
        terms["base"] / chips / (rates[base_fmt] * 1e9)
        + terms["side"] / chips / (rates["int8"] * 1e9)
        + terms["lm_head"] / chips / (lm_rate * 1e9)
        + terms["kv"] / chips / (hbm_gbps * 1e9)
    )
    if chips > 1:
        t += (2 * cfg.num_hidden_layers + 1) * ici_us * 1e-6
    return batch / t


def fit_e2e_rates(cfg: ModelConfig, step_s: Dict[str, float],
                  max_seq: int = 2048, hbm_gbps: float = H100_HBM_GBPS
                  ) -> Dict[str, float]:
    """The rates (GB/s) that make :func:`predict_decode_tok_s` give the
    measured batch-1 decode steps ``step_s`` (seconds, by format, with a
    bf16 lm_head, at ``max_seq``) of the model ``cfg``: int8 first, its
    bf16 lm_head at its own rate (bf16 takes the int8 rate), then each
    other format with the lm_head at that rate."""
    def terms(fmt):
        return _stream_terms(cfg, fmt, 1, max_seq, False)

    t8 = terms("int8")
    kv_s = t8["kv"] / (hbm_gbps * 1e9)
    r8 = (t8["base"] + t8["lm_head"]) / (step_s["int8"] - kv_s) / 1e9
    rates = {"int8": r8, "bf16": r8}
    for fmt, t in step_s.items():
        if fmt == "int8" or fmt in _MIXED_BASE:
            continue
        tf = terms(fmt)
        rest = t - tf["lm_head"] / (r8 * 1e9) - kv_s
        rates[fmt] = tf["base"] / rest / 1e9
    return rates


def parse_vq(spec: str):
    """'v8-k65536-256' -> (8, 65536, 256): the community model-name
    geometry convention (reference README.md:143-159)."""
    m = re.fullmatch(r"v(\d+)-k(\d+)-(\d+)", spec)
    if not m:
        raise ValueError(
            f"bad --vq spec {spec!r}; expected e.g. v8-k65536-256"
        )
    return tuple(int(g) for g in m.groups())


_META = torch.device("meta")


def _abs(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device=_META)


def _abs_linear(in_f: int, out_f: int, fmt: str, vq=None,
                row_shards: int = 1):
    """A runtime linear on the meta device with the encoders' exact shapes
    and dtypes (``layers/runtime.py`` ``to_int8`` / ``_encode_int4`` /
    ``_encode_int3`` / ``_encode_int2`` / ``to_bf16``; the loader's
    ``normalize_vq_layer`` for "codebook", at ``vq=(v, k, kres)``).
    ``row_shards > 1``: the blocked layout of a row-parallel layer
    (``_encode_*(shards=n)``): ``row_shards`` shards of ``ceil(in_f /
    row_shards)`` columns side by side, each padded on its own; bf16 has
    no blocks (its placement slices the columns)."""
    bits = {"int8": 8, "int4": 4, "int3": 3, "int2": 2}.get(fmt)
    if row_shards > 1 and bits is not None:
        blk = (in_f + row_shards - 1) // row_shards
        one = _one_linear(blk, out_f, fmt,
                          pad_to=blocked_pad(bits, blk)[1])
        return concat_blocked([one] * row_shards, row_shards)
    return _one_linear(in_f, out_f, fmt, vq)


def _one_linear(in_f: int, out_f: int, fmt: str, vq=None,
                pad_to: Optional[int] = None):
    """:func:`_abs_linear` on one device; ``pad_to``: the in axis's
    multiple (None: the one-device encoder's)."""
    if fmt == "codebook":
        from vptq_tpu_torch.layers.vqlinear import VQLinear
        from vptq_tpu_torch.ops.packing import index_plane_dtype

        v, k, kres = vq or (8, 65536, 256)
        lcfg = hbm.synth_vq_config(out_f, in_f, v, k, kres)
        n_idx = lcfg.num_indices
        return VQLinear(
            centroids=_abs((1, k, v), torch.bfloat16),
            ids=_abs((1, n_idx, in_f), index_plane_dtype(k)),
            res_centroids=_abs((1, kres, v), torch.bfloat16)
            if kres > 0 else None,
            res_ids=_abs((1, n_idx, in_f), index_plane_dtype(kres))
            if kres > 0 else None,
            weight_scale=_abs((in_f,), torch.bfloat16),
            weight_bias=_abs((in_f,), torch.bfloat16),
            cfg=lcfg,
        )
    if fmt == "int8":
        g = pick_group(in_f)
        in_p = in_f + ((-in_f) % (pad_to or g))
        return Int8Linear(
            wq=_abs((out_f, in_p), torch.int8),
            scales=_abs((in_p // g, out_f), torch.float32),
        )
    if fmt == "int4":
        in_p = in_f + ((-in_f) % (pad_to or 2048))
        return Int4Linear(
            wq=_abs((out_f, in_p // 2), torch.int8),
            scales=_abs((in_p // 128, out_f), torch.bfloat16),
        )
    if fmt == "int3":
        in_p = in_f + ((-in_f) % (pad_to or 2048))
        return Int3Linear(
            wq2=_abs((out_f, in_p // 4), torch.int8),
            wq1=_abs((out_f, in_p // 8), torch.int8),
            scales=_abs((out_f, in_p // 128), torch.bfloat16),
        )
    if fmt == "int2":
        in_p = in_f + ((-in_f) % (pad_to or 1024))
        return Int2Linear(
            wq=_abs((out_f, in_p // 4), torch.int8),
            scales=_abs((out_f, in_p // 64), torch.bfloat16),
        )
    if fmt == "bf16":
        return DenseLinear(weight=_abs((out_f, in_f), torch.bfloat16))
    raise ValueError(
        f"plan supports int8/int4/int3/int2/bf16/codebook, not {fmt!r}"
    )


def abstract_runtime_model(
    cfg: ModelConfig,
    fmt: str = "int4",
    quantize_lm_head: bool = True,
    tp_shards: int = 1,
    vq=None,
) -> Model:
    """The runtime :class:`Model` the loader builds (``fuse=True``), on
    the meta device: fused q|k|v and gate|up, stacked experts.

    ``fmt="codebook"``: unfused blocks of VQLinear at the ``vq=(v, k,
    kres)`` geometry (the loader never fuses codebook layers); MoE
    geometries need int8 / int4 (stacked experts). ``tp_shards`` > 1:
    the loader's model under a mesh of that many model ranks before
    placement, its row-parallel layers (o_proj, the dense and shared
    down_proj) in the blocked layout (the codebook format has none).
    """
    if fmt == "codebook" and tp_shards > 1:
        raise ValueError(
            "codebook format plans under GSPMD, not shard_map TP"
        )
    h = cfg.hidden_size
    nh, nkv, hd = (
        cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
    )
    inter = cfg.intermediate_size

    def norm(width=h):
        return _abs((width,), torch.float32)

    def abs_stacked(e: int, ein: int, eout_gateup: int, einter: int):
        """StackedExperts shapes (the encoders' stacking rules)."""
        if fmt not in ("int8", "int4"):
            raise ValueError("MoE plan needs int8/int4 (StackedExperts)")
        gate_up = _abs_linear(ein, eout_gateup, fmt)
        down = _abs_linear(einter, ein, fmt)
        return StackedExperts(
            gate_up_wq=_abs((e, *gate_up.wq.shape), torch.int8),
            gate_up_scales=_abs((e, *gate_up.scales.shape),
                                gate_up.scales.dtype),
            down_wq=_abs((e, *down.wq.shape), torch.int8),
            down_scales=_abs((e, *down.scales.shape), down.scales.dtype),
            fmt=fmt,
        )

    def dense_mlp(width: int) -> Mlp:
        return Mlp(
            gate_proj=None,
            up_proj=None,
            down_proj=_abs_linear(width, h, fmt, row_shards=tp_shards),
            gate_up_proj=_abs_linear(h, 2 * width, fmt),
        )

    if cfg.is_mla:
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        kv_lora = cfg.kv_lora_rank

        def mk_attn():
            if cfg.q_lora_rank:
                q_kwargs = dict(
                    q_a_proj=_abs_linear(h, cfg.q_lora_rank, fmt),
                    q_a_norm=norm(cfg.q_lora_rank),
                    q_b_proj=_abs_linear(
                        cfg.q_lora_rank, nh * (dn + dr), fmt
                    ),
                )
            else:
                q_kwargs = dict(q_proj=_abs_linear(h, nh * (dn + dr), fmt))
            return MlaAttention(
                kv_a_proj=_abs_linear(h, kv_lora + dr, fmt),
                kv_a_norm=norm(kv_lora),
                o_proj=_abs_linear(nh * dv, h, fmt, row_shards=tp_shards),
                uk=_abs((kv_lora, nh, dn), torch.bfloat16),
                uv=_abs((kv_lora, nh, dv), torch.bfloat16),
                **q_kwargs,
            )

        e = cfg.n_routed_experts
        mi = cfg.moe_intermediate_size

        def mk_mlp(layer_idx: int):
            if layer_idx < cfg.first_k_dense_replace:
                return dense_mlp(inter)
            return DeepseekMoe(
                router_weight=_abs((e, h), torch.float32),
                correction_bias=_abs((e,), torch.float32),
                experts=[],
                shared_experts=dense_mlp(mi * cfg.n_shared_experts),
                top_k=cfg.num_experts_per_tok,
                n_group=cfg.n_group,
                topk_group=cfg.topk_group,
                norm_topk_prob=cfg.norm_topk_prob,
                routed_scaling_factor=cfg.routed_scaling_factor,
                stacked=abs_stacked(e, h, 2 * mi, mi),
            )

        def mk_block(i):
            return Block(norm(), mk_attn(), norm(), mk_mlp(i))
    else:
        def mk_mlp():
            if cfg.num_local_experts:
                return MoeMlp(
                    router=_abs_linear(h, cfg.num_local_experts, "bf16"),
                    experts=[],
                    num_experts_per_tok=cfg.num_experts_per_tok,
                    stacked=abs_stacked(
                        cfg.num_local_experts, h, 2 * inter, inter
                    ),
                )
            if fmt == "codebook":
                return Mlp(
                    gate_proj=_abs_linear(h, inter, fmt, vq=vq),
                    up_proj=_abs_linear(h, inter, fmt, vq=vq),
                    down_proj=_abs_linear(inter, h, fmt, vq=vq),
                )
            return dense_mlp(inter)

        def mk_attn():
            if fmt == "codebook":
                return Attention(
                    q_proj=_abs_linear(h, nh * hd, fmt, vq=vq),
                    k_proj=_abs_linear(h, nkv * hd, fmt, vq=vq),
                    v_proj=_abs_linear(h, nkv * hd, fmt, vq=vq),
                    o_proj=_abs_linear(nh * hd, h, fmt, vq=vq),
                )
            return Attention(
                q_proj=None, k_proj=None, v_proj=None,
                o_proj=_abs_linear(nh * hd, h, fmt, row_shards=tp_shards),
                qkv_proj=_abs_linear(h, (nh + 2 * nkv) * hd, fmt),
            )

        def mk_block(_i):
            return Block(norm(), mk_attn(), norm(), mk_mlp())

    lm_head = None if cfg.tie_word_embeddings else _abs_linear(
        h, cfg.vocab_size, "int8" if quantize_lm_head else "bf16"
    )
    return Model(
        embed_tokens=_abs((cfg.vocab_size, h), torch.bfloat16),
        blocks=[mk_block(i) for i in range(cfg.num_hidden_layers)],
        norm=norm(),
        lm_head=lm_head,
        cfg=cfg,
    )


@contextlib.contextmanager
def _plain_versions():
    """Every kernel a decode step reaches swapped for its plain version
    inside the block (meta tensors have no memory to launch on)."""
    from vptq_tpu_torch.layers import runtime
    from vptq_tpu_torch.models import llama
    from vptq_tpu_torch.ops import (
        flash_attention,
        w2_matmul,
        w3_matmul,
        w4_matmul,
        w4_matmul_expert,
        w4_matmul_pairs,
        w8_matmul,
        w8_matmul_expert,
        w8_matmul_pairs,
    )

    swaps = [
        (runtime, "w8_matmul", w8_matmul.w8_matmul_reference),
        (runtime, "w4_matmul", w4_matmul.w4_matmul_reference),
        (runtime, "w3_matmul", w3_matmul.w3_matmul_reference),
        (runtime, "w2_matmul", w2_matmul.w2_matmul_reference),
        (llama, "flash_attention", flash_attention.flash_attention_reference),
    ]
    tables = {
        "_EXPERT_MATMUL": {
            "int8": w8_matmul_expert.w8_matmul_expert_reference,
            "int4": w4_matmul_expert.w4_matmul_expert_reference,
        },
        "_PAIRS_MATMUL": {
            "int8": w8_matmul_pairs.w8_matmul_pairs_reference,
            "int4": w4_matmul_pairs.w4_matmul_pairs_reference,
        },
    }
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    saved_tables = {name: dict(getattr(llama, name)) for name in tables}
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        for name, entries in tables.items():
            getattr(llama, name).update(entries)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        for name, entries in saved_tables.items():
            getattr(llama, name).update(entries)


def validate_plan(
    cfg: ModelConfig,
    fmt: str,
    batch: int = 1,
    max_seq: int = 2048,
    quantize_lm_head: bool = True,
    vq=None,
    tp: int = 1,
) -> Dict:
    """One decode step of ``forward`` at full geometry on the meta device:
    a token for each of ``batch`` sequences whose cache holds ``max_seq -
    1`` tokens (every live block attended). Raises where the model the
    plan describes cannot run its step: the failure a real load would hit,
    with zero weight bytes. ``tp > 1``: the step of one rank (rank 0) of
    a tensor-parallel group of ``tp``: the blocked model placed by
    ``tp.tp_place_model``, the cache cut by ``tp.shard_cache_tp``, and
    ``forward(tp=)``, whose collectives on meta tensors give their shapes
    and call no group. Returns the logits' shape and dtype, and the
    rank's weights' and cache's bytes."""
    from vptq_tpu_torch.parallel.mesh import Mesh
    from vptq_tpu_torch.parallel.tp import (
        shard_cache_tp,
        tp_place_model,
        tp_validate,
    )

    if tp > 1:
        tp_validate(cfg, tp, sharded_lm_head=not cfg.tie_word_embeddings)
    # a codebook layer has no blocked layout: its placement splits the
    # index planes
    model = abstract_runtime_model(
        cfg, fmt, quantize_lm_head, tp_shards=1 if fmt == "codebook" else tp,
        vq=vq)
    cache = init_cache(cfg, batch, max_seq, torch.bfloat16, _META)
    cache.reset(max_seq - 1)
    axis = None
    if tp > 1:
        mesh = Mesh(data=1, model=tp, rank=0, device=_META)
        model = tp_place_model(model, mesh, reencode_rows=False)
        cache = shard_cache_tp(cache, mesh)
        axis = mesh.tp
    tokens = _abs((batch, 1), torch.int64)
    with torch.inference_mode(), _plain_versions():
        logits, _ = forward(model, tokens, cache, dtype=torch.bfloat16,
                            tp=axis)
    return dict(
        logits_shape=tuple(logits.shape),
        logits_dtype=str(logits.dtype),
        weights_bytes=hbm.model_bytes(model),
        kv_bytes=sum(t.numel() * t.element_size()
                     for t in (*cache.k, *cache.v)),
    )


def _placement(cfg: ModelConfig, per_slice: int) -> tuple:
    """(tp, pp) of one host's ``per_slice`` devices: the largest TP degree
    that divides them and that the geometry shards (``tp_validate``;
    GQA caps it at the KV heads), pipeline stages for the rest (stages
    may be uneven: ``ceil(L / pp)`` layers at most)."""
    from vptq_tpu_torch.parallel.tp import tp_validate

    tp = 1
    for cand in range(per_slice, 0, -1):
        if per_slice % cand:
            continue
        try:
            tp_validate(cfg, cand)
        except ValueError:
            continue
        tp = cand
        break
    return tp, per_slice // tp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--geometry", required=True, choices=sorted(GEOMETRIES))
    ap.add_argument(
        "--format", default="int4",
        choices=(
            "int8", "int4", "int3", "int3-mixed", "int2", "int2-mixed",
            "bf16", "codebook",
        ),
    )
    ap.add_argument(
        "--hosts", type=int, default=1,
        help="hosts, each a data-parallel replica: --chips is the TOTAL "
        "device count, each host gets chips / hosts devices, whose "
        "tensor-parallel and pipeline ranks never cross hosts",
    )
    ap.add_argument(
        "--vq", default="v8-k65536-256",
        help="VQ geometry for --format codebook "
        "(model-name convention, e.g. v8-k65536-256)",
    )
    ap.add_argument("--chips", type=int, default=1,
                    help="devices in all")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--max-seq", type=int, default=2048)
    ap.add_argument(
        "--parallel", default="tp", choices=("tp", "gspmd"),
        help="placement over several devices: tp, tensor parallelism and "
        "pipeline stages; gspmd, the codebook format's (its index planes "
        "split over every device of a host)",
    )
    ap.add_argument(
        "--hbm-gb", type=float, default=None,
        help="the device's memory in GB (default: the card's)",
    )
    ap.add_argument(
        "--compile", action="store_true",
        help="also run one rank's decode step on the meta device",
    )
    ap.add_argument(
        "--ici-us", type=float, default=ICI_US,
        help="per-collective latency of the decode cost model, µs: an "
        "assumption (the JAX package's), not measured between cards",
    )
    args = ap.parse_args(argv)

    if args.format == "codebook" and args.parallel == "tp":
        # the codebook format's only placement over devices is GSPMD's
        print("# codebook plans under GSPMD (no shard_map-TP path)")
        args.parallel = "gspmd"
    if args.parallel == "gspmd" and args.format != "codebook":
        raise SystemExit(f"--parallel gspmd: {_GSPMD}")
    hbm_bytes = (int(args.hbm_gb * hbm.GiB) if args.hbm_gb
                 else hbm.detect_hbm_bytes())
    if not hbm_bytes:
        raise SystemExit(
            f"{sys.argv[0]}: no CUDA device to read the memory of; pass "
            "--hbm-gb"
        )
    cfg = ModelConfig(**{
        **dict(tie_word_embeddings=False, model_type="llama"),
        **GEOMETRIES[args.geometry],
    })
    vq = parse_vq(args.vq)
    if args.chips % args.hosts:
        print(f"OVER: chips {args.chips} % hosts {args.hosts} != 0")
        return 1
    per_slice = args.chips // args.hosts
    gspmd = args.parallel == "gspmd"
    tp, pp = (1, 1) if gspmd else _placement(cfg, per_slice)
    # the width of the model axis: tp, or every device of the host under
    # gspmd
    model_chips = per_slice if gspmd else tp

    est = hbm.estimate_model_bytes(cfg, args.format, tp_shards=tp,
                                   default_vq=vq)
    kv = hbm.kv_cache_bytes(cfg, args.batch, args.max_seq)
    table = hbm.budget_table(
        cfg, hbm_bytes=hbm_bytes, batch=args.batch, max_seq=args.max_seq,
        formats=(
            "codebook", "int2", "int2-mixed", "int3", "int3-mixed",
            "int4", "int8", "bf16",
        ),
        default_vq=vq,
    )
    print(f"# {args.geometry} @ {args.format}, {args.chips} device(s) of "
          f"{hbm_bytes / hbm.GiB:.1f} GiB = {args.hosts} host(s) x "
          f"(pp={pp} x tp={tp})")
    print(hbm.format_budget_table(table))
    try:
        hbm.check_budget(
            est["total"] + kv, per_slice, hbm_bytes,
            what=f"{args.geometry} ({args.format})",
        )
    except hbm.HBMBudgetError as e:
        print(f"OVER BUDGET: {e}")
        return 1
    print(f"fits: {(est['total'] + kv) / per_slice / hbm.GiB:.2f} GiB/device "
          f"of {hbm_bytes / hbm.GiB:.1f} (the weights live once per host)")

    def host_tok_s(ici):
        # one host's replica: the stages stream one after another, each
        # tp wide (the weights' time is the model's over tp whatever pp),
        # plus a hop a stage boundary a step
        pred = predict_decode_tok_s(
            cfg, args.format, model_chips, args.batch, args.max_seq,
            ici_us=ici, rates=E2E_GBPS, hbm_gbps=H100_HBM_GBPS)
        return args.batch / (args.batch / pred + (pp - 1) * ici * 1e-6)

    try:
        tok_s = host_tok_s(args.ici_us)
    except ValueError as e:
        print(f"predicted decode: none ({e})")
    else:
        bar = ""
        if per_slice > 1:
            lo, hi = (host_tok_s(u) for u in ICI_US_RANGE)
            bar = (f" [{lo:.1f}..{hi:.1f} over an assumed ici_us "
                   f"{ICI_US_RANGE[0]:g}..{ICI_US_RANGE[1]:g} a collective, "
                   "not measured between cards]")
        print(f"predicted decode: {tok_s:.1f} tok/s per host @ batch "
              f"{args.batch}{bar} (rates fitted on {E2E_CARD})")
        if args.hosts > 1 or pp > 1:
            print(f"aggregate throughput: {args.hosts} host(s) x {pp} "
                  f"pipelined microbatch(es) -> up to "
                  f"{args.hosts * pp * tok_s:.1f} tok/s at batch >= "
                  f"{pp * args.batch} per host (1F schedule, "
                  "parallel/pipeline.py)")

    if args.compile:
        fmt = _MIXED_BASE.get(args.format, args.format)
        if fmt != args.format:
            print(f"# the meta step runs the {fmt} base plan (the "
                  "calibrated int8 sides are a calibration output)")
        cfg_c = cfg
        if pp > 1:
            cfg_c = dataclasses.replace(
                cfg, num_hidden_layers=-(-cfg.num_hidden_layers // pp))
            print(f"# the meta step runs one of {pp} pipeline stages "
                  f"({cfg_c.num_hidden_layers} layers, tp={tp})")
        step = validate_plan(cfg_c, fmt, args.batch, args.max_seq, vq=vq,
                             tp=model_chips)
        rank = (f" of one rank of {'gspmd' if gspmd else 'tp'}="
                f"{model_chips}" if model_chips > 1 else "")
        print(f"meta decode step{rank}: logits {step['logits_shape']} "
              f"{step['logits_dtype']}, weights "
              f"{step['weights_bytes'] / hbm.GiB:.2f} GiB, cache "
              f"{step['kv_bytes'] / hbm.GiB:.2f} GiB")
        print("decode step runs on the meta device: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
