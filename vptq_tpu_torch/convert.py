"""Carry a model's parameters across from the JAX package's layout.

The input is a flat dict of numpy arrays keyed by the JAX model's tree
path (``embed_tokens``, ``blocks.0.attn.qkv_proj.wq``, ...) plus the HF
config dict; the output is the port's :class:`Model` holding the same
numbers, so both packages can be run on one set of weights. The flat
dict keeps no class names, so the kind of each linear follows from its
leaves: ``wq2`` and ``wq1`` are int3; ``wq`` is int8, int4 or int2 by
the dtype and shape of its ``scales`` (see :func:`_packed_kind`);
``weight`` is dense; ``centroids`` is a codebook layer whose geometry
comes from the config's ``quantization_config``; ``col_idx`` is a
calibrated mixed layer whose base lies under ``int2`` or ``int3`` and
whose int8 side under ``int8``. A Mixtral block's
``mlp`` holds ``router``, ``experts.<e>`` and, after fusion, ``stacked``,
whose format (int8 or int4) follows from its scales as a ``wq``'s does. A
DeepSeek block's ``attn`` holds ``kv_a_proj``, ``kv_a_norm``, ``o_proj``,
``q_proj`` (or ``q_a_proj``, ``q_a_norm``, ``q_b_proj``) and the absorbed
``uk`` / ``uv``; its ``mlp`` (past ``first_k_dense_replace``) holds
``router_weight``, ``correction_bias``, ``experts.<e>`` or ``stacked``,
and ``shared_experts``.
bf16 arrays are taken by bit pattern.

:func:`convert_shard` carries one rank's shard of a model the JAX package
placed for tensor parallelism (``tp_place_model``): each leaf given as
its per-device arrays in the mesh's device order, it builds the port's
local :class:`Model` from those of one device, the shard that
``parallel/tp.py`` ``tp_place_model`` places on that rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from vptq_tpu_torch.config import QuantizationConfig
from vptq_tpu_torch.layers.dense import DenseLinear
from vptq_tpu_torch.layers.runtime import (
    Int2Linear,
    Int2MixedLinear,
    Int3Linear,
    Int3MixedLinear,
    Int4Linear,
    Int8Linear,
)
from vptq_tpu_torch.layers.vqlinear import VQLinear
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
)
from vptq_tpu_torch.models.loader import resolve_device
from vptq_tpu_torch.ops.packing import INT4_GROUP, to_index_plane
from vptq_tpu_torch.ops.w2_matmul import W2_GROUPS

__all__ = ["convert_params", "convert_shard"]


# the JAX Mlp's fields and their names in a dense and in a Mixtral
# checkpoint (fused gate_up has no checkpoint name of its own: a fused
# layer is never a codebook layer, which alone is looked up by name)
_HF_MLP = {
    "gate_proj": "gate_proj", "up_proj": "up_proj", "down_proj": "down_proj",
    "gate_up_proj": "gate_up_proj",
}
_HF_EXPERT = {
    "gate_proj": "w1", "up_proj": "w3", "down_proj": "w2",
    "gate_up_proj": "gate_up_proj",
}
# the JAX MlaAttention's linears and their checkpoint names
_HF_MLA = {
    "kv_a_proj": "kv_a_proj_with_mqa", "o_proj": "o_proj",
    "q_proj": "q_proj", "q_a_proj": "q_a_proj", "q_b_proj": "q_b_proj",
}


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)  # writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _packed_kind(prefix: str, wq: np.ndarray, scales: np.ndarray):
    """The layer class of a ``wq`` + ``scales`` pair; raises unless
    exactly one format fits.

    int8: f32 scales (in_p / g, out) with in_p = wq.shape[1];
    int4: bf16 scales (in_p / 128, out) with in_p = 2·wq.shape[1];
    int2: bf16 scales (out, in_p / g), g ∈ {64, 128}, in_p = 4·wq.shape[1].
    """
    out_f, n = wq.shape
    s0, s1 = scales.shape
    kinds = []
    if scales.dtype == np.float32 and s1 == out_f and s0 and n % s0 == 0:
        kinds.append(Int8Linear)
    if scales.dtype.name == "bfloat16":
        if (s0, s1) == (2 * n // INT4_GROUP, out_f):
            kinds.append(Int4Linear)
        if s0 == out_f and s1 and 4 * n % s1 == 0 and 4 * n // s1 in W2_GROUPS:
            kinds.append(Int2Linear)
    if len(kinds) != 1:
        raise ValueError(
            f"{prefix}: cannot tell the format of wq {wq.shape} with "
            f"{scales.dtype} scales {scales.shape}"
        )
    return kinds[0]


def _stacked_format(prefix: str, params: Dict[str, np.ndarray]) -> str:
    """"int8" or "int4" for the leaves of a JAX ``StackedExperts``, by the
    rule of :func:`_packed_kind` on each of its two weights; raises
    unless both fit the same one format."""
    kinds = {
        _packed_kind(
            f"{prefix}.{name}",
            params[f"{prefix}.{name}_wq"][0],
            params[f"{prefix}.{name}_scales"][0],
        )
        for name in ("gate_up", "down")
    }
    fmt = {Int8Linear: "int8", Int4Linear: "int4"}.get(
        kinds.pop() if len(kinds) == 1 else None
    )
    if fmt is None:
        raise ValueError(f"{prefix}: stacked experts are int8 or int4")
    return fmt


def convert_params(
    params: Dict[str, np.ndarray], hf_config: dict, device=None
) -> Model:
    """The port's Model, on CUDA unless ``device`` says otherwise."""
    device = resolve_device(device)
    cfg = ModelConfig.from_hf_dict(hf_config)
    qcfg = QuantizationConfig.from_dict(
        hf_config.get("quantization_config", {})
    )

    def get(name) -> Optional[torch.Tensor]:
        a = params.get(name)
        return None if a is None else _tensor(a).to(device)

    def plane(name, num_centroids):
        t = get(name)
        if t is None:
            return None
        # the JAX planes are uint8 or uint16 arrays
        return to_index_plane(t.to(torch.int64), num_centroids)

    def linear(prefix: str, hf_prefix: Optional[str]):
        if f"{prefix}.col_idx" in params:
            kind, base = (
                (Int2MixedLinear, "int2") if f"{prefix}.int2.wq" in params
                else (Int3MixedLinear, "int3")
            )
            return kind(
                linear(f"{prefix}.{base}", None),
                linear(f"{prefix}.int8", None),
                get(f"{prefix}.col_idx"),
                get(f"{prefix}.bias"),
            )
        if f"{prefix}.wq2" in params:
            return Int3Linear(
                get(f"{prefix}.wq2"),
                get(f"{prefix}.wq1"),
                get(f"{prefix}.scales"),
                get(f"{prefix}.bias"),
            )
        if f"{prefix}.wq" in params:
            kind = _packed_kind(
                prefix, params[f"{prefix}.wq"], params[f"{prefix}.scales"]
            )
            return kind(
                get(f"{prefix}.wq"),
                get(f"{prefix}.scales"),
                get(f"{prefix}.bias"),
            )
        if f"{prefix}.weight" in params:
            return DenseLinear(get(f"{prefix}.weight"), get(f"{prefix}.bias"))
        if f"{prefix}.centroids" in params:
            lc = qcfg.lookup(hf_prefix)
            inv_perm = get(f"{prefix}.inv_perm")
            return VQLinear(
                centroids=get(f"{prefix}.centroids"),
                ids=plane(f"{prefix}.ids", lc.num_main_centroids),
                res_centroids=get(f"{prefix}.res_centroids"),
                res_ids=plane(f"{prefix}.res_ids", lc.num_main_res_centroids),
                outlier_centroids=get(f"{prefix}.outlier_centroids"),
                outlier_ids=plane(
                    f"{prefix}.outlier_ids", lc.num_outlier_centroids
                ),
                inv_perm=(
                    None if inv_perm is None else inv_perm.to(torch.int64)
                ),
                weight_scale=get(f"{prefix}.weight_scale"),
                weight_bias=get(f"{prefix}.weight_bias"),
                bias=get(f"{prefix}.bias"),
                cfg=lc,
            )
        return None

    def dense_mlp(prefix: str, hf_prefix: str, hf_names: dict) -> Mlp:
        return Mlp(
            **{
                name: linear(f"{prefix}.{name}", f"{hf_prefix}.{hf_name}")
                for name, hf_name in hf_names.items()
            }
        )

    def stacked_at(prefix: str) -> Optional[StackedExperts]:
        if f"{prefix}.stacked.gate_up_wq" not in params:
            return None
        sp = f"{prefix}.stacked"
        return StackedExperts(
            get(f"{sp}.gate_up_wq"), get(f"{sp}.gate_up_scales"),
            get(f"{sp}.down_wq"), get(f"{sp}.down_scales"),
            fmt=_stacked_format(sp, params),
        )

    def moe_mlp(prefix: str, hf_prefix: str) -> MoeMlp:
        stacked = stacked_at(prefix)
        n_experts = 0 if stacked is not None else cfg.num_local_experts
        return MoeMlp(
            router=linear(f"{prefix}.router", f"{hf_prefix}.gate"),
            experts=[
                dense_mlp(
                    f"{prefix}.experts.{e}", f"{hf_prefix}.experts.{e}",
                    _HF_EXPERT,
                )
                for e in range(n_experts)
            ],
            num_experts_per_tok=cfg.num_experts_per_tok,
            stacked=stacked,
        )

    def mla_attention(prefix: str, hf_prefix: str) -> MlaAttention:
        return MlaAttention(
            **{
                name: linear(f"{prefix}.{name}", f"{hf_prefix}.{hf_name}")
                for name, hf_name in _HF_MLA.items()
            },
            **{
                name: get(f"{prefix}.{name}")
                for name in ("kv_a_norm", "q_a_norm", "uk", "uv")
            },
        )

    def deepseek_moe(prefix: str, hf_prefix: str) -> DeepseekMoe:
        stacked = stacked_at(prefix)
        n_experts = 0 if stacked is not None else cfg.n_routed_experts
        return DeepseekMoe(
            router_weight=get(f"{prefix}.router_weight"),
            correction_bias=get(f"{prefix}.correction_bias"),
            experts=[
                dense_mlp(
                    f"{prefix}.experts.{e}", f"{hf_prefix}.experts.{e}",
                    _HF_MLP,
                )
                for e in range(n_experts)
            ],
            shared_experts=dense_mlp(
                f"{prefix}.shared_experts", f"{hf_prefix}.shared_experts",
                _HF_MLP,
            ),
            top_k=cfg.num_experts_per_tok,
            n_group=cfg.n_group,
            topk_group=cfg.topk_group,
            norm_topk_prob=cfg.norm_topk_prob,
            routed_scaling_factor=cfg.routed_scaling_factor,
            stacked=stacked,
        )

    blocks = []
    for i in range(cfg.num_hidden_layers):
        b, hf = f"blocks.{i}", f"model.layers.{i}"
        if cfg.is_mla:
            attn = mla_attention(f"{b}.attn", f"{hf}.self_attn")
        else:
            attn = Attention(
                **{
                    name: linear(f"{b}.attn.{name}",
                                 f"{hf}.self_attn.{name}")
                    for name in (
                        "q_proj", "k_proj", "v_proj", "o_proj", "qkv_proj"
                    )
                }
            )
        if f"{b}.mlp.router_weight" in params:
            mlp = deepseek_moe(f"{b}.mlp", f"{hf}.mlp")
        elif cfg.num_local_experts:
            mlp = moe_mlp(f"{b}.mlp", f"{hf}.block_sparse_moe")
        else:
            mlp = dense_mlp(f"{b}.mlp", f"{hf}.mlp", _HF_MLP)
        blocks.append(
            Block(
                input_layernorm=get(f"{b}.input_layernorm"),
                attn=attn,
                post_attention_layernorm=get(f"{b}.post_attention_layernorm"),
                mlp=mlp,
            )
        )
    return Model(
        embed_tokens=get("embed_tokens"),
        blocks=blocks,
        norm=get("norm"),
        lm_head=linear("lm_head", "lm_head"),
        cfg=cfg,
    )


def convert_shard(
    shards: Dict[str, Sequence[np.ndarray]], hf_config: dict, rank: int,
    device=None,
) -> Model:
    """Rank ``rank``'s shard of a model the JAX package placed over a mesh:
    ``shards`` maps each tree path to the leaf's per-device arrays in the
    mesh's device order (a replicated leaf: the same array on each);
    returns the port's local Model of device ``rank``'s arrays (the
    config stays the whole model's)."""
    return convert_params(
        {name: parts[rank] for name, parts in shards.items()}, hf_config,
        device,
    )
