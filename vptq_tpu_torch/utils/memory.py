"""Device-memory budget accounting for model loading and serving.

Port of ``vptq_tpu/utils/memory.py``. The reference caps per-GPU memory
with its ``gpu_utilization`` heuristic (reference:
vptq/layers/model_base.py:165-181). Here the question "does model X in
runtime format F fit?" is answered BEFORE the load starts, from config
geometry alone: the fmt × devices budget table, and a hard error with a
suggestion when the configuration cannot fit.

All sizes are bytes unless a name says otherwise. The port keeps the JAX
package's runtime layouts, so every estimate is the JAX package's integer:
exact for the dense runtime formats (the encoders' padding rules in
``layers/runtime.py``) and for ``codebook`` (the checkpoint's own
``VQLinearConfig`` geometry). ``row_shards`` / ``tp_shards`` are the
blocked tensor-parallel encodings' arithmetic (``parallel/tp.py``; the
loader checks the budget over the model axis's devices). There is no
default card size:
:func:`detect_hbm_bytes` reads the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from vptq_tpu_torch.config import VQLinearConfig
from vptq_tpu_torch.layers.runtime import (
    INT2_MIXED_COL_FRACTION,
    INT3_MIXED_COL_FRACTION,
    pick_group,
)

__all__ = [
    "HBMBudgetError",
    "linear_runtime_bytes",
    "model_geometry",
    "estimate_model_bytes",
    "synth_vq_config",
    "kv_cache_bytes",
    "model_bytes",
    "budget_table",
    "format_budget_table",
    "check_budget",
    "detect_hbm_bytes",
]

GiB = 1024 ** 3


class HBMBudgetError(RuntimeError):
    """Raised when a model cannot fit the requested device budget."""


def _int8_bytes(out_f: int, in_f: int, row_shards: int = 1) -> int:
    if row_shards > 1:
        # blocked encoding: each column block is padded and grouped
        # independently
        blk = (in_f + row_shards - 1) // row_shards
        return row_shards * _int8_bytes(out_f, blk)
    g = pick_group(in_f)
    in_p = in_f + ((-in_f) % g)
    return out_f * in_p + 4 * out_f * (in_p // g)


def _int4_bytes(out_f: int, in_f: int, row_shards: int = 1) -> int:
    if row_shards > 1:
        blk = (in_f + row_shards - 1) // row_shards
        # per-shard pad: 512, or 256 for sub-512 shards
        in_p = blk + ((-blk) % (512 if blk >= 512 else 256))
        return row_shards * (out_f * in_p // 2 + 2 * out_f * (in_p // 128))
    in_p = in_f + ((-in_f) % 2048)
    return out_f * in_p // 2 + 2 * out_f * (in_p // 128)


def _int3_bytes(out_f: int, in_f: int, row_shards: int = 1) -> int:
    if row_shards > 1:
        blk = (in_f + row_shards - 1) // row_shards
        in_p = blk + ((-blk) % 1024)  # per-shard pad (W3_BLOCK)
        return row_shards * (
            out_f * in_p * 3 // 8 + 2 * out_f * (in_p // 128)
        )
    in_p = in_f + ((-in_f) % 2048)
    return out_f * in_p * 3 // 8 + 2 * out_f * (in_p // 128)


def _mixed_cols_per_shard(blk: int, col_frac: float) -> int:
    """Calibration's int8 column count of a site ``blk`` columns wide
    (``quant/calibrate.py`` ``_select_cols``): every column below 128."""
    if blk < 128:
        return blk
    k_s = max(128, int(round(blk * col_frac)))
    k_s = ((k_s + 127) // 128) * 128
    return min(k_s, blk - blk % 128 if blk % 128 else blk)


def _mixed_side_bytes(out_f: int, in_f: int, row_shards: int,
                      col_frac: float) -> int:
    """The int8 side matrix of a mixed layer: k int8 columns and f32
    scales per 128-column group (a 128-column floor per shard)."""
    blk = in_f // row_shards if row_shards > 1 else in_f
    k = _mixed_cols_per_shard(blk, col_frac) * max(1, row_shards)
    return out_f * k + 4 * out_f * (-(-k // 128) * 128 // 128)


def _int3_mixed_bytes(out_f: int, in_f: int, row_shards: int = 1) -> int:
    """int3 planes over all columns (``Int3MixedLinear``) + the int8 side
    on ``INT3_MIXED_COL_FRACTION`` of the input columns."""
    return _int3_bytes(out_f, in_f, row_shards) + _mixed_side_bytes(
        out_f, in_f, row_shards, INT3_MIXED_COL_FRACTION
    )


def _int2_bytes(out_f: int, in_f: int, row_shards: int = 1) -> int:
    """One 2-bit plane + bf16 scales per 64 input columns (``Int2Linear``,
    ~2.25 bits a weight)."""
    if row_shards > 1:
        blk = (in_f + row_shards - 1) // row_shards
        in_p = blk + ((-blk) % 1024)  # per-shard pad (W2_BLOCK)
        return row_shards * (out_f * in_p // 4 + 2 * out_f * (in_p // 64))
    in_p = in_f + ((-in_f) % 1024)
    return out_f * in_p // 4 + 2 * out_f * (in_p // 64)


def _int2_mixed_bytes(out_f: int, in_f: int, row_shards: int = 1) -> int:
    """The int2 plane over all columns (``Int2MixedLinear``) + the int8
    side on ``INT2_MIXED_COL_FRACTION`` of the input columns."""
    return _int2_bytes(out_f, in_f, row_shards) + _mixed_side_bytes(
        out_f, in_f, row_shards, INT2_MIXED_COL_FRACTION
    )


def _codebook_bytes(cfg: VQLinearConfig) -> int:
    """Exact byte count of a normalized VQLinear (the loader's layout,
    ``models/loader.py`` ``normalize_vq_layer``): index planes uint16
    (k > 256, held as int16) or uint8; codebooks and norm vectors bf16;
    the inverse permutation int32."""
    c = cfg.num_codebooks
    k, v = cfg.num_main_centroids, cfg.vector_len
    n = 0
    id_w = 2 if k > 256 else 1
    n += c * cfg.num_indices * cfg.group_size * id_w  # ids
    n += c * k * v * 2  # centroids bf16
    if cfg.enable_residual:
        res_w = 2 if cfg.num_main_res_centroids > 256 else 1
        n += c * cfg.num_indices * cfg.group_size * res_w
        n += c * cfg.num_main_res_centroids * v * 2
    if cfg.enable_outlier:
        ow = 2 if cfg.num_outlier_centroids > 256 else 1
        n += cfg.outlier_num_indices * cfg.outlier_size * ow
        n += cfg.num_outlier_centroids * cfg.outlier_vector_len * 2
    if cfg.enable_perm:
        n += 4 * cfg.in_features  # inv_perm int32
    if cfg.enable_norm:
        n += 2 * 2 * cfg.in_features  # weight_scale + weight_bias bf16
    if cfg.bias:
        n += 2 * cfg.out_features
    return n


_FORMAT_BYTES = {
    "int8": _int8_bytes,
    "int4": _int4_bytes,
    "int3": _int3_bytes,
    "int3-mixed": _int3_mixed_bytes,
    "int2": _int2_bytes,
    "int2-mixed": _int2_mixed_bytes,
}


def linear_runtime_bytes(
    out_f: int, in_f: int, fmt: str, vq_cfg=None, row_shards: int = 1
) -> int:
    """Bytes one linear occupies in runtime format ``fmt``.

    ``vq_cfg`` (a :class:`VQLinearConfig`) is required for
    ``fmt="codebook"``; dense layers under "codebook" stay bf16.
    ``row_shards``: the blocked encoding of a row-parallel layer
    (per-shard padding).
    """
    if fmt in _FORMAT_BYTES:
        return _FORMAT_BYTES[fmt](out_f, in_f, row_shards)
    if fmt == "bf16":
        return 2 * out_f * in_f
    if fmt == "codebook":
        if vq_cfg is None:
            return 2 * out_f * in_f  # dense layer stays bf16
        return _codebook_bytes(vq_cfg)
    raise ValueError(f"unknown runtime format {fmt!r}")


@dataclasses.dataclass(frozen=True)
class LinearGeom:
    name: str  # tail name used for quantization_config lookup
    out_features: int
    in_features: int
    count: int  # how many instances across the model
    # True where tensor parallelism shards the in axis (o_proj and the
    # dense / shared-expert down_proj); routed-expert weights shard on
    # the expert axis and stay whole per device
    row_parallel: bool = False


def model_geometry(cfg) -> List[LinearGeom]:
    """Per-role linear geometry of a :class:`ModelConfig`: dense Llama /
    Qwen / Mistral, Mixtral-style MoE, DeepSeek MLA + fine-grained MoE."""
    h = cfg.hidden_size
    L = cfg.num_hidden_layers
    geoms: List[LinearGeom] = []

    if cfg.is_mla:
        qk, dv = cfg.qk_head_dim, cfg.v_head_dim
        nh = cfg.num_attention_heads
        if cfg.q_lora_rank:
            geoms.append(LinearGeom("q_a_proj", cfg.q_lora_rank, h, L))
            geoms.append(LinearGeom("q_b_proj", nh * qk, cfg.q_lora_rank, L))
        else:
            geoms.append(LinearGeom("q_proj", nh * qk, h, L))
        geoms.append(LinearGeom(
            "kv_a_proj_with_mqa", cfg.kv_lora_rank + cfg.qk_rope_head_dim,
            h, L,
        ))
        geoms.append(LinearGeom(
            "kv_b_proj", nh * (cfg.qk_nope_head_dim + dv), cfg.kv_lora_rank,
            L,
        ))
        geoms.append(LinearGeom("o_proj", h, nh * dv, L, row_parallel=True))
    else:
        nh, nkv, hd = (
            cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
        )
        geoms.append(LinearGeom("q_proj", nh * hd, h, L))
        geoms.append(LinearGeom("k_proj", nkv * hd, h, L))
        geoms.append(LinearGeom("v_proj", nkv * hd, h, L))
        geoms.append(LinearGeom("o_proj", h, nh * hd, L, row_parallel=True))

    if cfg.n_routed_experts:  # DeepSeek MoE
        dense_layers = min(cfg.first_k_dense_replace, L)
        moe_layers = L - dense_layers
        inter = cfg.intermediate_size
        for nm in ("gate_proj", "up_proj"):
            geoms.append(LinearGeom(nm, inter, h, dense_layers))
        geoms.append(LinearGeom(
            "down_proj", h, inter, dense_layers, row_parallel=True
        ))
        mi = cfg.moe_intermediate_size
        n_exp = cfg.n_routed_experts
        for nm in ("gate_proj", "up_proj"):
            geoms.append(LinearGeom(nm, mi, h, moe_layers * n_exp))
        geoms.append(LinearGeom("down_proj", h, mi, moe_layers * n_exp))
        shared = cfg.n_shared_experts
        if shared:
            for nm in ("gate_proj", "up_proj"):
                geoms.append(LinearGeom(nm, mi * shared, h, moe_layers))
            geoms.append(LinearGeom(
                "down_proj", h, mi * shared, moe_layers, row_parallel=True,
            ))
    elif cfg.num_local_experts:  # Mixtral MoE
        inter = cfg.intermediate_size
        n_exp = cfg.num_local_experts
        geoms.append(LinearGeom("w1", inter, h, L * n_exp))
        geoms.append(LinearGeom("w3", inter, h, L * n_exp))
        geoms.append(LinearGeom("w2", h, inter, L * n_exp))
    else:
        inter = cfg.intermediate_size
        geoms.append(LinearGeom("gate_proj", inter, h, L))
        geoms.append(LinearGeom("up_proj", inter, h, L))
        geoms.append(LinearGeom("down_proj", h, inter, L, row_parallel=True))
    return geoms


def _lookup_geom(qcfg, tail: str, out_f: int, in_f: int):
    """The VQLinearConfig of a geometry row: ``config_for_layers`` keys are
    full module paths, so match by tail name, preferring an entry of the
    same in / out features (MoE checkpoints reuse tail names at other
    shapes)."""
    vq = qcfg.lookup(tail)
    if vq is not None:
        return vq
    fallback = None
    for k, v in qcfg.config_for_layers.items():
        if k.split(".")[-1] != tail:
            continue
        if v.in_features == in_f and v.out_features == out_f:
            return v
        fallback = fallback or v
    return fallback


def synth_vq_config(
    out_f: int, in_f: int, v: int = 8, k: int = 65536, kres: int = 256
) -> VQLinearConfig:
    """A planning-mode VQLinearConfig: the community checkpoint geometry
    (v{v}-k{k}-{kres}, one codebook, norm, no outliers) at the given
    linear shape, to budget the ``codebook`` format before any checkpoint
    exists."""
    return VQLinearConfig(
        in_features=in_f,
        out_features=out_f,
        vector_lens=(-1, v),
        num_centroids=(-1, k),
        num_res_centroids=(-1, kres),
        group_num=1,
        group_size=in_f,
        outlier_size=0,
        enable_norm=True,
    )


def estimate_model_bytes(
    cfg,
    fmt: str,
    qcfg=None,
    quantize_lm_head: bool = False,
    tp_shards: int = 1,
    default_vq=None,
) -> Dict[str, int]:
    """Predicted device bytes of a loaded model, from geometry alone.

    Returns a breakdown dict with a ``"total"`` key. ``qcfg`` (a
    :class:`QuantizationConfig`) selects which layers are quantized;
    layers without a quantization entry stay bf16 (the loader's rule).
    ``tp_shards > 1``: the blocked per-shard encoding of row-parallel
    layers.
    """
    h = cfg.hidden_size
    out: Dict[str, int] = {}
    blocks = 0
    for g in model_geometry(cfg):
        row_shards = tp_shards if tp_shards > 1 and g.row_parallel else 1
        if g.name == "kv_b_proj":
            # absorbed into bf16 uk / uv at load (latent attention)
            blocks += 2 * g.out_features * g.in_features * g.count
            continue
        if qcfg is not None:
            vq = _lookup_geom(qcfg, g.name, g.out_features, g.in_features)
            if vq is None and fmt != "bf16":
                # unquantized layer: dense bf16 whatever the format
                per = 2 * g.out_features * g.in_features
            else:
                per = linear_runtime_bytes(
                    g.out_features, g.in_features, fmt, vq, row_shards
                )
        else:
            # planning mode (no checkpoint yet): every block linear in
            # the runtime format; for "codebook" a default VQ geometry
            # (v, k, kres) stands in for the per-layer configs
            vq = None
            if fmt == "codebook" and default_vq is not None:
                vq = synth_vq_config(
                    g.out_features, g.in_features, *default_vq
                )
            per = linear_runtime_bytes(
                g.out_features, g.in_features, fmt, vq, row_shards
            )
        blocks += per * g.count
    out["blocks"] = blocks
    # layernorms: 2 f32 vectors per layer + the final norm
    out["norms"] = 4 * h * (2 * cfg.num_hidden_layers + 1)
    out["embed"] = 2 * cfg.vocab_size * h
    if cfg.tie_word_embeddings:
        out["lm_head"] = 0
    elif quantize_lm_head:
        out["lm_head"] = _int8_bytes(cfg.vocab_size, h)
    else:
        out["lm_head"] = 2 * cfg.vocab_size * h
    out["total"] = sum(out.values())
    return out


def kv_cache_bytes(
    cfg, batch: int, max_seq: int, dtype_bytes: int = 2
) -> int:
    # MLA caches one shared latent head (models/llama.py init_cache)
    kv_heads = 1 if cfg.is_mla else cfg.num_key_value_heads
    per_layer = (
        batch * max_seq * kv_heads
        * (cfg.cache_k_dim + cfg.cache_v_dim) * dtype_bytes
    )
    return per_layer * cfg.num_hidden_layers


def model_bytes(model: torch.nn.Module) -> int:
    """Bytes the weights of a loaded model hold on their device: every
    persistent buffer (what a checkpoint of the model holds, not the
    rope frequencies or the expert ids derived from the config), each
    byte of a storage counted once however many buffers view it (stacked
    experts, a tied lm_head)."""
    spans: Dict[Tuple[str, int], List[Tuple[int, int]]] = {}
    total = 0
    for t in model.state_dict(keep_vars=True).values():
        if t is None:
            continue
        n = t.numel() * t.element_size()
        if t.device.type == "meta":  # no storage to share
            total += n
            continue
        key = (str(t.device), t.untyped_storage().data_ptr())
        start = t.storage_offset() * t.element_size()
        spans.setdefault(key, []).append((start, start + n))
    for ranges in spans.values():
        end = -1
        for lo, hi in sorted(ranges):
            lo = max(lo, end)
            if hi > lo:
                total += hi - lo
            end = max(end, hi)
    return total


def detect_hbm_bytes(device=None) -> Optional[int]:
    """The card's memory in bytes (``device``, default the current CUDA
    device), or None when there is no card."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.get_device_properties(
        torch.device("cuda") if device is None else torch.device(device)
    ).total_memory)


def budget_table(
    cfg,
    qcfg=None,
    formats: Tuple[str, ...] = ("codebook", "int4", "int8", "bf16"),
    chip_counts: Tuple[int, ...] = (1, 2, 4, 8),
    hbm_bytes: Optional[int] = None,
    batch: int = 1,
    max_seq: int = 2048,
    utilization: float = 0.9,
    default_vq=None,
) -> List[Dict]:
    """fmt × n_devices → bytes per device (weights + KV cache).

    ``fits`` assumes the weights shard evenly over the devices and the
    KV cache over heads. ``hbm_bytes`` defaults to the card's memory
    (:func:`detect_hbm_bytes`); without a card it must be given.
    """
    if hbm_bytes is None:
        hbm_bytes = detect_hbm_bytes()
        if hbm_bytes is None:
            raise ValueError("no card to read the memory of: pass hbm_bytes")
    kv = kv_cache_bytes(cfg, batch, max_seq)
    rows = []
    for fmt in formats:
        est = estimate_model_bytes(cfg, fmt, qcfg, default_vq=default_vq)
        row = {
            "format": fmt,
            "weights_gib": est["total"] / GiB,
            "kv_gib": kv / GiB,
            "per_chip_gib": {},
            "min_chips": None,
        }
        for n in chip_counts:
            per = (est["total"] + kv) / n
            row["per_chip_gib"][n] = per / GiB
            if row["min_chips"] is None and per <= hbm_bytes * utilization:
                row["min_chips"] = n
        rows.append(row)
    return rows


def format_budget_table(rows: List[Dict]) -> str:
    chip_counts = sorted(rows[0]["per_chip_gib"])
    head = (
        f"{'format':>9} {'weights':>9} {'kv':>7} "
        + " ".join(f"{n}-chip".rjust(8) for n in chip_counts)
        + "  min_chips"
    )
    lines = [head]
    for r in rows:
        cells = " ".join(
            f"{r['per_chip_gib'][n]:7.2f}G" for n in chip_counts
        )
        mc = r["min_chips"] if r["min_chips"] is not None else ">max"
        lines.append(
            f"{r['format']:>9} {r['weights_gib']:8.2f}G"
            f" {r['kv_gib']:6.2f}G {cells} {str(mc):>9}"
        )
    return "\n".join(lines)


def check_budget(
    total_bytes: int,
    n_devices: int,
    hbm_bytes: int,
    utilization: float = 0.9,
    what: str = "model",
) -> None:
    """Fail with a suggestion when ``what`` exceeds the budget (the
    reference's ``gpu_utilization`` cap, model_base.py:165-181, but
    failing fast instead of offloading). The message is the JAX
    package's."""
    per_chip = total_bytes / max(n_devices, 1)
    budget = hbm_bytes * utilization
    if per_chip <= budget:
        return
    need = math.ceil(total_bytes / budget)
    raise HBMBudgetError(
        f"{what} needs {per_chip / GiB:.2f} GiB/chip on {n_devices} "
        f"chip(s), over the {budget / GiB:.2f} GiB budget "
        f"({hbm_bytes / GiB:.1f} GiB × {utilization:.0%}). "
        f"Suggestions: shard over ≥{need} chips (pass a mesh with "
        f"model={need}), or pick a smaller runtime_format "
        f"(int4 halves int8; codebook is the checkpoint's own "
        f"~2-3 bits/weight), or lower max_seq/batch to shrink the "
        f"KV cache."
    )
