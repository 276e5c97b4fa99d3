"""Write synthetic VPTQ checkpoints in the community on-disk format.

Port of ``vptq_tpu/utils/synth_checkpoint.py`` for the dense Llama
layout (Llama, Mistral, and Qwen2 with its q/k/v bias) and the Mixtral
layout (a router and per-expert w1 / w3 / w2): packed
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
    prefix: str, cfg: VQLinearConfig, seed: int, dtype, std: float
) -> Dict[str, np.ndarray]:
    """Tensors of one quantized linear, checkpoint-format."""
    planes = make_numpy_planes(cfg, seed=seed, dtype=dtype, std=std)
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


def write_synthetic_checkpoint(
    path: str,
    model_cfg: Optional[ModelConfig] = None,
    vq_kwargs: Optional[dict] = None,
    seed: int = 0,
    dtype=np.float16,
    qkv_bias: bool = False,
    std: float = 0.5,
) -> Path:
    """Create ``path`` with config.json + model.safetensors.

    ``vq_kwargs`` override :func:`make_config` geometry (in/out features
    are filled in per projection). ``qkv_bias`` gives q_proj, k_proj and
    v_proj a bias, as Qwen2 has. ``std`` is the codebook spread: the
    JAX package's 0.5 grows the residual stream over many wide layers,
    so a deep full-width model passes a smaller one. A ``sliding_window``
    of ``model_cfg`` goes into config.json (the JAX package's writer
    leaves it out).
    """
    mc = model_cfg or tiny_model_config()
    moe = mc.num_local_experts > 0
    if (
        mc.is_mla
        or mc.model_type not in _ARCHITECTURES
        or moe != (mc.model_type == "mixtral")
    ):
        raise NotImplementedError(
            "the port writes dense Llama, Mistral, Qwen2 and Mixtral "
            "checkpoints"
        )
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
    if moe:
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
    linears = []  # (prefix, cfg, seed), in the order the seeds are drawn
    for i in range(mc.num_hidden_layers):
        for name, (in_f, out_f) in proj_shapes.items():
            prefix = f"model.layers.{i}.{name}"
            has_bias = qkv_bias and name in (
                "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
            )
            cfg = make_config(
                in_features=in_f, out_features=out_f, bias=has_bias,
                **vq_kwargs
            )
            linears.append((prefix, cfg, int(rng.integers(1 << 31))))
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
    if not mc.tie_word_embeddings:
        tensors["lm_head.weight"] = (
            0.02 * rng.standard_normal((mc.vocab_size, h))
        ).astype(dtype)

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for made in pool.map(
            lambda job: _layer_tensors(
                job[0], job[1], seed=job[2], dtype=dtype, std=std
            ),
            linears,
        ):
            tensors.update(made)
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
