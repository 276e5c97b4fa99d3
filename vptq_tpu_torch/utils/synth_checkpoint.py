"""Write synthetic VPTQ checkpoints in the community on-disk format.

Port of ``vptq_tpu/utils/synth_checkpoint.py`` for the dense Llama
layout (Llama, Mistral, and Qwen2 with its q/k/v bias), Phi-3's fused
layout (qkv_proj, gate_up_proj), the Mixtral layout (a router and
per-expert w1 / w3 / w2) and DeepSeek-V3's (MLA's q / q_a / q_b,
kv_a_proj_with_mqa, kv_b_proj and their norms; a dense MLP below
``first_k_dense_replace``, then an f32 router with its correction bias,
per-expert and shared gate / up / down): packed
int32 index streams, uint16-viewed-as-int16 perms and indices, and the
``quantization_config`` block in config.json. For one seed it writes
the same tensors as the JAX package's writer. Packing is word-wise
(``ops/packing.py``) and the linears, each drawn from a seed of its own,
are made by a few threads at once (numpy and torch release the
interpreter lock), which keeps a checkpoint at Llama-3.1-8B width to a
second or two per layer.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from vptq_tpu_torch.config import VQLinearConfig
from vptq_tpu_torch.models.llama import ModelConfig
from vptq_tpu_torch.models.loader import write_safetensors
from vptq_tpu_torch.ops.packing import pack_index
from vptq_tpu_torch.utils.synth import make_config, make_numpy_planes

__all__ = ["tiny_model_config", "write_synthetic_checkpoint"]

# the model types the writer knows, and their HF architecture names
_ARCHITECTURES = {
    "llama": "LlamaForCausalLM",
    "mistral": "MistralForCausalLM",
    "qwen2": "Qwen2ForCausalLM",
    "mixtral": "MixtralForCausalLM",
    "phi3": "Phi3ForCausalLM",
    "phi3_v": "Phi3VForCausalLM",
    "deepseek_v3": "DeepseekV3ForCausalLM",
}


def tiny_model_config(**overrides) -> ModelConfig:
    defaults = dict(
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        head_dim=16,
        rms_norm_eps=1e-5,
        rope_theta=10000.0,
        tie_word_embeddings=True,
        model_type="llama",
    )
    defaults.update(overrides)
    return ModelConfig(**defaults)


def _layer_tensors(
    prefix: str, cfg: VQLinearConfig, seed: int, dtype, std: float,
    heavy_tailed: bool = False,
) -> Dict[str, np.ndarray]:
    """Tensors of one quantized linear, checkpoint-format."""
    planes = make_numpy_planes(cfg, seed=seed, dtype=dtype, std=std,
                               heavy_tailed=heavy_tailed)
    c, k, v = cfg.num_codebooks, cfg.num_main_centroids, cfg.vector_len
    view = np.float16 if cfg.indices_as_float else np.int16

    out: Dict[str, np.ndarray] = {}
    out[f"{prefix}.centroids.weight"] = planes["centroids"].reshape(c, k * v)
    if cfg.is_indice_packed:
        res = planes["res_ids"]
        out[f"{prefix}.indices"] = pack_index(
            torch.from_numpy(planes["ids"].astype(np.int64)),
            cfg.index_bits,
            None if res is None else torch.from_numpy(res.astype(np.int64)),
            cfg.res_index_bits,
        ).numpy()
    else:
        out[f"{prefix}.indices"] = planes["ids"].astype(np.uint16).view(view)
        if planes["res_ids"] is not None:
            out[f"{prefix}.res_indices"] = (
                planes["res_ids"].astype(np.uint16).view(view)
            )
    if planes["res_centroids"] is not None:
        kr = cfg.num_main_res_centroids
        out[f"{prefix}.res_centroids.weight"] = planes[
            "res_centroids"
        ].reshape(c, kr * v)
    if planes["outlier_centroids"] is not None:
        ko, vo = cfg.num_outlier_centroids, cfg.outlier_vector_len
        out[f"{prefix}.outlier_centroids.weight"] = planes[
            "outlier_centroids"
        ].reshape(1, ko * vo)
        out[f"{prefix}.outlier_indices"] = (
            planes["outlier_ids"].astype(np.uint16).view(view)
        )
    if planes["perm"] is not None:
        out[f"{prefix}.perm"] = planes["perm"].view(np.int16)
    if planes["weight_scale"] is not None:
        out[f"{prefix}.weight_scale"] = planes["weight_scale"].astype(dtype)
        out[f"{prefix}.weight_bias"] = planes["weight_bias"].astype(dtype)
    if planes["bias"] is not None:
        out[f"{prefix}.bias"] = planes["bias"].astype(dtype)
    return out


def _write_bins(tensors: Dict[str, np.ndarray], root: Path, n: int) -> None:
    """``tensors`` as ``n`` ``torch.save`` pickles, split in name order;
    more than one gets the index HF writes beside them."""
    names = sorted(tensors)
    files = (["pytorch_model.bin"] if n == 1 else [
        f"pytorch_model-{i + 1:05d}-of-{n:05d}.bin" for i in range(n)])
    weight_map = {}
    for i, file in enumerate(files):
        part = names[i * len(names) // n: (i + 1) * len(names) // n]
        torch.save(
            {k: torch.from_numpy(np.ascontiguousarray(tensors[k]))
             for k in part},
            root / file,
        )
        weight_map.update(dict.fromkeys(part, file))
    if n > 1:
        with open(root / "pytorch_model.bin.index.json", "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f, indent=2)


def _deepseek_layer(mc: ModelConfig, i: int, shapes: dict, tensors: dict,
                    rng, dtype) -> None:
    """Layer ``i``'s MLP linears into ``shapes`` (a dense MLP below
    ``first_k_dense_replace``, else the routed and shared experts) and its
    router, correction bias and MLA norms into ``tensors``, drawing from
    ``rng`` where the JAX package's writer does (before the linears'
    seeds)."""
    h, p = mc.hidden_size, f"model.layers.{i}"
    if i < mc.first_k_dense_replace or mc.n_routed_experts == 0:
        inter = mc.intermediate_size
        shapes["mlp.gate_proj"] = (h, inter)
        shapes["mlp.up_proj"] = (h, inter)
        shapes["mlp.down_proj"] = (inter, h)
    else:
        mi = mc.moe_intermediate_size
        for e in range(mc.n_routed_experts):
            shapes[f"mlp.experts.{e}.gate_proj"] = (h, mi)
            shapes[f"mlp.experts.{e}.up_proj"] = (h, mi)
            shapes[f"mlp.experts.{e}.down_proj"] = (mi, h)
        smi = mi * mc.n_shared_experts
        shapes["mlp.shared_experts.gate_proj"] = (h, smi)
        shapes["mlp.shared_experts.up_proj"] = (h, smi)
        shapes["mlp.shared_experts.down_proj"] = (smi, h)
        tensors[f"{p}.mlp.gate.weight"] = (
            0.05 * rng.standard_normal((mc.n_routed_experts, h))
        ).astype(np.float32)
        tensors[f"{p}.mlp.gate.e_score_correction_bias"] = (
            0.1 * rng.standard_normal(mc.n_routed_experts)
        ).astype(np.float32)
    tensors[f"{p}.self_attn.kv_a_layernorm.weight"] = np.ones(
        mc.kv_lora_rank, dtype=dtype)
    if mc.q_lora_rank:
        tensors[f"{p}.self_attn.q_a_layernorm.weight"] = np.ones(
            mc.q_lora_rank, dtype=dtype)


def _deepseek_config(mc: ModelConfig) -> dict:
    """config.json's DeepSeek keys, as the JAX package's writer sets them."""
    return {
        "q_lora_rank": mc.q_lora_rank,
        "kv_lora_rank": mc.kv_lora_rank or None,
        "qk_nope_head_dim": mc.qk_nope_head_dim,
        "qk_rope_head_dim": mc.qk_rope_head_dim,
        "v_head_dim": mc.v_head_dim,
        "rope_interleave": mc.rope_interleave,
        "moe_intermediate_size": mc.moe_intermediate_size,
        "n_routed_experts": mc.n_routed_experts or None,
        "n_shared_experts": mc.n_shared_experts or None,
        "n_group": mc.n_group,
        "topk_group": mc.topk_group,
        "norm_topk_prob": mc.norm_topk_prob,
        "routed_scaling_factor": mc.routed_scaling_factor,
        "first_k_dense_replace": mc.first_k_dense_replace,
    }


def write_synthetic_checkpoint(
    path: str,
    model_cfg: Optional[ModelConfig] = None,
    vq_kwargs: Optional[dict] = None,
    seed: int = 0,
    dtype=np.float16,
    qkv_bias: bool = False,
    std: float = 0.5,
    bin_shards: int = 0,
    vq_lm_head: bool = False,
    heavy_tailed: bool = False,
) -> Path:
    """Create ``path`` with config.json + model.safetensors (or, with
    ``bin_shards`` n > 0, n ``pytorch_model*.bin`` pickles: one file, or n
    shards and their ``pytorch_model.bin.index.json``).

    ``vq_kwargs`` override :func:`make_config` geometry (in/out features
    are filled in per projection). ``qkv_bias`` gives q_proj, k_proj and
    v_proj a bias, as Qwen2 has. ``std`` is the codebook spread: the
    JAX package's 0.5 grows the residual stream over many wide layers,
    so a deep full-width model passes a smaller one. A ``sliding_window``
    of ``model_cfg`` goes into config.json (the JAX package's writer
    leaves it out).

    ``vq_lm_head``: the lm_head as a VQ layer (some community checkpoints
    quantize the vocabulary projection too; Gaussian codebooks, as the
    JAX package draws it); it needs untied embeddings. ``heavy_tailed``:
    the decoder's linears with :func:`make_numpy_planes`'s heavy-tailed
    statistics.
    """
    mc = model_cfg or tiny_model_config()
    moe = mc.num_local_experts > 0
    if (
        mc.model_type not in _ARCHITECTURES
        or moe != (mc.model_type == "mixtral")
        or mc.is_mla != (mc.model_type == "deepseek_v3")
    ):
        raise NotImplementedError(
            "the port writes dense Llama, Mistral, Qwen2, Phi-3, Mixtral "
            "and DeepSeek-V3 checkpoints"
        )
    if vq_lm_head and mc.tie_word_embeddings:
        raise ValueError("vq_lm_head requires tie_word_embeddings=False")
    vq_kwargs = dict(vq_kwargs or {})
    root = Path(path)
    root.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(seed)
    h = mc.hidden_size
    q_out = mc.num_attention_heads * mc.head_dim
    kv_out = mc.num_key_value_heads * mc.head_dim
    inter = mc.intermediate_size
    proj_shapes = {
        "self_attn.q_proj": (h, q_out),
        "self_attn.k_proj": (h, kv_out),
        "self_attn.v_proj": (h, kv_out),
        "self_attn.o_proj": (q_out, h),
    }
    if mc.is_mla:
        nh = mc.num_attention_heads
        proj_shapes = {
            "self_attn.kv_a_proj_with_mqa": (
                h, mc.kv_lora_rank + mc.qk_rope_head_dim),
            "self_attn.kv_b_proj": (
                mc.kv_lora_rank, nh * (mc.qk_nope_head_dim + mc.v_head_dim)),
            "self_attn.o_proj": (nh * mc.v_head_dim, h),
        }
        if mc.q_lora_rank:
            proj_shapes["self_attn.q_a_proj"] = (h, mc.q_lora_rank)
            proj_shapes["self_attn.q_b_proj"] = (
                mc.q_lora_rank, nh * mc.qk_head_dim)
        else:
            proj_shapes["self_attn.q_proj"] = (h, nh * mc.qk_head_dim)
    elif mc.model_type in ("phi3", "phi3_v"):
        # Phi-3 checkpoints ship q|k|v and gate|up fused
        proj_shapes = {
            "self_attn.qkv_proj": (h, q_out + 2 * kv_out),
            "self_attn.o_proj": (q_out, h),
            "mlp.gate_up_proj": (h, 2 * inter),
            "mlp.down_proj": (inter, h),
        }
    elif moe:
        for e in range(mc.num_local_experts):
            proj_shapes[f"block_sparse_moe.experts.{e}.w1"] = (h, inter)
            proj_shapes[f"block_sparse_moe.experts.{e}.w3"] = (h, inter)
            proj_shapes[f"block_sparse_moe.experts.{e}.w2"] = (inter, h)
    else:
        proj_shapes["mlp.gate_proj"] = (h, inter)
        proj_shapes["mlp.up_proj"] = (h, inter)
        proj_shapes["mlp.down_proj"] = (inter, h)

    tensors: Dict[str, np.ndarray] = {}
    config_for_layers: Dict[str, dict] = {}
    # (prefix, cfg, seed, heavy-tailed), in the order the seeds are drawn
    linears = []
    for i in range(mc.num_hidden_layers):
        layer_shapes = dict(proj_shapes)
        if mc.is_mla:
            _deepseek_layer(mc, i, layer_shapes, tensors, rng, dtype)
        for name, (in_f, out_f) in layer_shapes.items():
            prefix = f"model.layers.{i}.{name}"
            has_bias = qkv_bias and name in (
                "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
            )
            cfg = make_config(
                in_features=in_f, out_features=out_f, bias=has_bias,
                **vq_kwargs
            )
            linears.append(
                (prefix, cfg, int(rng.integers(1 << 31)), heavy_tailed))
            config_for_layers[prefix] = cfg.to_dict()
        if moe:
            tensors[f"model.layers.{i}.block_sparse_moe.gate.weight"] = (
                0.02 * rng.standard_normal((mc.num_local_experts, h))
            ).astype(dtype)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            tensors[f"model.layers.{i}.{norm}.weight"] = (
                np.ones(h, dtype=dtype)
                + 0.01 * rng.standard_normal(h).astype(dtype)
            )

    tensors["model.embed_tokens.weight"] = (
        0.02 * rng.standard_normal((mc.vocab_size, h))
    ).astype(dtype)
    tensors["model.norm.weight"] = np.ones(h, dtype=dtype)
    if vq_lm_head:
        cfg = make_config(in_features=h, out_features=mc.vocab_size,
                          **vq_kwargs)
        linears.append(("lm_head", cfg, int(rng.integers(1 << 31)), False))
        config_for_layers["lm_head"] = cfg.to_dict()
    elif not mc.tie_word_embeddings:
        tensors["lm_head.weight"] = (
            0.02 * rng.standard_normal((mc.vocab_size, h))
        ).astype(dtype)

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for made in pool.map(
            lambda job: _layer_tensors(
                job[0], job[1], seed=job[2], dtype=dtype, std=std,
                heavy_tailed=job[3],
            ),
            linears,
        ):
            tensors.update(made)
    if bin_shards:
        _write_bins(tensors, root, bin_shards)
    else:
        write_safetensors(tensors, root / "model.safetensors")

    hf_config = {
        "architectures": [_ARCHITECTURES[mc.model_type]],
        "model_type": mc.model_type,
        "vocab_size": mc.vocab_size,
        "hidden_size": mc.hidden_size,
        "intermediate_size": mc.intermediate_size,
        "num_hidden_layers": mc.num_hidden_layers,
        "num_attention_heads": mc.num_attention_heads,
        "num_key_value_heads": mc.num_key_value_heads,
        "head_dim": mc.head_dim,
        "rms_norm_eps": mc.rms_norm_eps,
        "rope_theta": mc.rope_theta,
        "attention_bias": qkv_bias,
        "max_position_embeddings": mc.max_position_embeddings,
        "num_local_experts": mc.num_local_experts,
        "num_experts_per_tok": mc.num_experts_per_tok,
        "tie_word_embeddings": mc.tie_word_embeddings,
        **(_deepseek_config(mc) if mc.is_mla else {}),
        "torch_dtype": "float16" if dtype == np.float16 else "bfloat16",
        "quantization_config": {
            "quant_method": "vptq",
            "config_for_layers": config_for_layers,
        },
    }
    if mc.rope_scaling is not None:
        hf_config["rope_scaling"] = dict(mc.rope_scaling)
    if mc.sliding_window is not None:
        hf_config["sliding_window"] = mc.sliding_window
    with open(root / "config.json", "w") as f:
        json.dump(hf_config, f, indent=2)
    return root
