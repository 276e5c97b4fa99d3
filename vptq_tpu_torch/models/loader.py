"""HF checkpoint ingestion: VPTQ safetensors → runtime modules.

Port of ``vptq_tpu/models/loader.py`` for dense Llama and Mixtral on one
device.
The safetensors format is read directly (8-byte header length, JSON
header, raw little-endian bytes; bf16 included) with ``torch.frombuffer``
on a memory map, so no package beyond torch is needed. Each quantized
layer is moved to the load device as stored, then normalized there:

  * the uint16-viewed-as-float16/int16 dtype trick is undone
    (reference vqlinear.py:110-113) by ``ops.packing.view_as_uint16``,
    which stands for the JAX loader's ``_to_numpy_intview``,
  * bit-packed int32 index streams are unpacked word by word,
  * the input permutation is inverted once,
  * codebooks, norm scale and bias are cast to the load dtype before
    the f32 dequant, as the JAX package does,

and re-encoded to the requested runtime format (``layers/runtime.py``).
"""

from __future__ import annotations

import json
import logging
import mmap
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from vptq_tpu_torch.config import QuantizationConfig, VQLinearConfig
from vptq_tpu_torch.layers.dense import DenseLinear
from vptq_tpu_torch.layers.runtime import (
    RUNTIME_FORMATS,
    dense_to_int8,
    fuse_block,
    to_runtime,
)
from vptq_tpu_torch.layers.vqlinear import VQLinear
from vptq_tpu_torch.models.llama import (
    Attention,
    Block,
    Mlp,
    Model,
    ModelConfig,
    MoeMlp,
)
from vptq_tpu_torch.ops.packing import (
    to_index_plane,
    unpack_index,
    view_as_uint16,
)

logger = logging.getLogger("vptq_tpu_torch")

__all__ = [
    "load_model",
    "load_state_dict",
    "normalize_vq_layer",
    "resolve_device",
    "write_safetensors",
]

_SAFETENSORS_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "U16": torch.uint16,
    "U32": torch.uint32,
    "U64": torch.uint64,
    "BOOL": torch.bool,
}
_SAFETENSORS_CODES = {v: k for k, v in _SAFETENSORS_DTYPES.items()}
# the JAX loader's calibrated formats (mixed int8 outlier sites)
CALIBRATED_FORMATS = ("int4-mixed", "int3-mixed", "int2-mixed")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless told otherwise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def _read_safetensors(path: Path) -> Dict[str, torch.Tensor]:
    """CPU tensors viewing a private memory map of one shard."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        base = 8 + n
        # copy-on-write map: writable for torch, the file is never touched
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES[meta["dtype"]]
        start, end = meta["data_offsets"]
        shape = meta["shape"]
        if end == start:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        itemsize = torch.empty((), dtype=dtype).element_size()
        out[name] = torch.frombuffer(
            data, dtype=dtype, count=(end - start) // itemsize,
            offset=base + start,
        ).reshape(shape)
    return out


def write_safetensors(tensors: Dict[str, torch.Tensor], path) -> None:
    """Write CPU tensors (or numpy arrays) as one safetensors file."""
    items = []
    for name, t in tensors.items():
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
        items.append((name, t.detach().cpu().contiguous()))
    # larger elements first keeps every tensor aligned to its itemsize
    items.sort(key=lambda kv: (-kv[1].element_size(), kv[0]))
    header, offset = {}, 0
    for name, t in items:
        nbytes = t.numel() * t.element_size()
        header[name] = {
            "dtype": _SAFETENSORS_CODES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for _, t in items:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
    os.replace(tmp, path)


def load_state_dict(checkpoint_dir: str) -> Dict[str, torch.Tensor]:
    """Read all safetensors shards (``*.index.json`` maps honoured)."""
    root = Path(checkpoint_dir)
    index_files = sorted(root.glob("*.safetensors.index.json"))
    if index_files:
        with open(index_files[0]) as f:
            weight_map = json.load(f)["weight_map"]
        shards = sorted({root / v for v in weight_map.values()})
    else:
        shards = sorted(root.glob("*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"no *.safetensors found in {root}")
    state: Dict[str, torch.Tensor] = {}
    for shard in shards:
        state.update(_read_safetensors(shard))
    return state


def normalize_vq_layer(
    prefix: str,
    state: Dict[str, torch.Tensor],
    cfg: VQLinearConfig,
    dtype: torch.dtype,
    device,
) -> VQLinear:
    """Build one :class:`VQLinear` on ``device`` from checkpoint tensors.

    ``prefix`` is the module path, e.g. ``model.layers.0.self_attn.q_proj``;
    tensor names follow the reference module's state dict.
    """

    def pop(name: str) -> Optional[torch.Tensor]:
        t = state.pop(f"{prefix}.{name}", None)
        return None if t is None else t.to(device)

    def cast(t):
        return None if t is None else t.to(dtype)

    centroids = pop("centroids.weight")
    if centroids is None:
        raise KeyError(f"{prefix}: missing centroids.weight")
    c, k, v = cfg.num_codebooks, cfg.num_main_centroids, cfg.vector_len
    centroids = centroids.reshape(c, k, v).to(dtype)

    indices_raw = pop("indices")
    res_ids = None
    if cfg.is_indice_packed:
        packed = indices_raw
        if packed.dtype != torch.int32:
            packed = packed.view(torch.int32)
        packed = packed.reshape(c, cfg.num_indices, cfg.packed_group_size)
        main, res = unpack_index(
            packed, cfg.index_bits, cfg.group_size, cfg.res_index_bits
        )
        # the JAX package narrows the unpacked ids to uint16 first
        ids = to_index_plane(main & 0xFFFF, k)
        if res is not None:
            res_ids = to_index_plane(res & 0xFFFF, cfg.num_main_res_centroids)
    else:
        plane_shape = (c, cfg.num_indices, cfg.group_size)
        ids = to_index_plane(
            view_as_uint16(indices_raw).reshape(plane_shape), k
        )
        res_raw = pop("res_indices")
        if res_raw is not None:
            res_ids = to_index_plane(
                view_as_uint16(res_raw).reshape(plane_shape),
                cfg.num_main_res_centroids,
            )

    res_centroids = pop("res_centroids.weight")
    if res_centroids is not None:
        res_centroids = res_centroids.reshape(
            c, cfg.num_main_res_centroids, v
        ).to(dtype)

    outlier_centroids = pop("outlier_centroids.weight")
    outlier_ids = None
    if outlier_centroids is not None:
        outlier_centroids = outlier_centroids.reshape(
            1, cfg.num_outlier_centroids, cfg.outlier_vector_len
        ).to(dtype)
        outlier_ids = to_index_plane(
            view_as_uint16(pop("outlier_indices")).reshape(
                1, cfg.outlier_num_indices, cfg.outlier_size
            ),
            cfg.num_outlier_centroids,
        )

    perm_raw = pop("perm")
    inv_perm = None
    if perm_raw is not None and cfg.enable_perm:
        inv_perm = torch.argsort(view_as_uint16(perm_raw).to(torch.int64))

    return VQLinear(
        centroids=centroids,
        ids=ids,
        res_centroids=res_centroids,
        res_ids=res_ids,
        outlier_centroids=outlier_centroids,
        outlier_ids=outlier_ids,
        inv_perm=inv_perm,
        weight_scale=cast(pop("weight_scale")),
        weight_bias=cast(pop("weight_bias")),
        bias=cast(pop("bias")),
        cfg=cfg,
    )


def _linear(
    prefix: str,
    state: Dict[str, torch.Tensor],
    qcfg: QuantizationConfig,
    dtype,
    device,
):
    layer_cfg = qcfg.lookup(prefix)
    if layer_cfg is not None:
        return normalize_vq_layer(prefix, state, layer_cfg, dtype, device)
    weight = state.pop(f"{prefix}.weight").to(device).to(dtype)
    bias = state.pop(f"{prefix}.bias", None)
    return DenseLinear(
        weight=weight, bias=None if bias is None else bias.to(device).to(dtype)
    )


def _check_supported(cfg: ModelConfig) -> None:
    missing = []
    if cfg.n_routed_experts:
        missing.append("DeepSeek's MoE")
    if cfg.num_local_experts and cfg.model_type != "mixtral":
        missing.append(f"MoE of model_type {cfg.model_type!r}")
    if cfg.is_mla:
        missing.append("MLA attention")
    if cfg.model_type in ("phi3", "phi3_v", "phimoe"):
        missing.append("the Phi-3 fused checkpoint layout")
    if missing:
        raise NotImplementedError(
            "vptq_tpu_torch runs dense Llama, Mistral, Qwen2 and Mixtral; "
            "not ported yet: "
            + ", ".join(missing)
        )


def load_model(
    checkpoint_dir: str,
    dtype=torch.bfloat16,
    runtime_format: str = "codebook",
    fuse: bool = True,
    quantize_lm_head: bool = False,
    device=None,
) -> Model:
    """Load a local VPTQ HF checkpoint directory into a :class:`Model`.

    ``runtime_format``: "codebook" keeps the compressed VQ layers;
    "int8", "int4", "int3", "int2" and "bf16" re-encode each layer once
    (``layers/runtime.py``), leaving dense layers such as the lm_head
    as they are. The calibrated "int4-mixed", "int3-mixed" and
    "int2-mixed" raise: they need GPTQ calibration, not ported yet.
    ``fuse`` merges q|k|v and gate|up (dense formats only) and stacks
    the experts of a Mixtral checkpoint (int8 and int4), layer by layer,
    so one layer's experts exist twice at most.
    ``quantize_lm_head`` re-encodes the dense lm_head to int8 too.
    ``device``: CUDA unless given; the weights are normalized and
    re-encoded there, layer by layer.
    """
    device = resolve_device(device)
    if runtime_format in CALIBRATED_FORMATS:
        raise NotImplementedError(
            f"runtime_format {runtime_format!r} is encoded by GPTQ "
            "calibration (ROADMAP M15), which is not ported; plain "
            "round-to-nearest would be a different model"
        )
    if runtime_format not in RUNTIME_FORMATS:
        raise ValueError(f"unknown runtime format {runtime_format!r}")
    root = Path(checkpoint_dir)
    with open(root / "config.json") as f:
        hf_config = json.load(f)
    model_cfg = ModelConfig.from_hf_dict(hf_config)
    _check_supported(model_cfg)
    qcfg = QuantizationConfig.from_dict(
        hf_config.get("quantization_config", {})
    )
    state = load_state_dict(str(root))

    def lin(prefix):
        return to_runtime(
            _linear(prefix, state, qcfg, dtype, device), runtime_format
        )

    def norm_weight(name):
        return state.pop(name).to(device).to(torch.float32)

    def moe_mlp(p):
        # Mixtral layout: block_sparse_moe.gate + experts.E.w1/w3/w2
        # (w1 = gate, w3 = up, w2 = down); the router stays a plain linear
        experts = []
        for e in range(model_cfg.num_local_experts):
            ep = f"{p}.block_sparse_moe.experts.{e}"
            experts.append(
                Mlp(
                    gate_proj=lin(f"{ep}.w1"),
                    up_proj=lin(f"{ep}.w3"),
                    down_proj=lin(f"{ep}.w2"),
                )
            )
        return MoeMlp(
            router=lin(f"{p}.block_sparse_moe.gate"),
            experts=experts,
            num_experts_per_tok=model_cfg.num_experts_per_tok,
        )

    def dense_mlp(p):
        return Mlp(
            gate_proj=lin(f"{p}.mlp.gate_proj"),
            up_proj=lin(f"{p}.mlp.up_proj"),
            down_proj=lin(f"{p}.mlp.down_proj"),
        )

    make_mlp = moe_mlp if model_cfg.num_local_experts else dense_mlp
    blocks = []
    for i in range(model_cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        block = Block(
            input_layernorm=norm_weight(f"{p}.input_layernorm.weight"),
            attn=Attention(
                q_proj=lin(f"{p}.self_attn.q_proj"),
                k_proj=lin(f"{p}.self_attn.k_proj"),
                v_proj=lin(f"{p}.self_attn.v_proj"),
                o_proj=lin(f"{p}.self_attn.o_proj"),
            ),
            post_attention_layernorm=norm_weight(
                f"{p}.post_attention_layernorm.weight"
            ),
            mlp=make_mlp(p),
        )
        if fuse and runtime_format != "codebook":
            fuse_block(block)
        blocks.append(block)

    embed = state.pop("model.embed_tokens.weight").to(device).to(dtype)
    norm = norm_weight("model.norm.weight")
    lm_head = None
    if not model_cfg.tie_word_embeddings:
        if "lm_head.weight" in state or qcfg.lookup("lm_head") is not None:
            lm_head = lin("lm_head")
    if quantize_lm_head and isinstance(lm_head, DenseLinear):
        lm_head = dense_to_int8(lm_head)

    leftover = [k for k in state if "rotary" not in k]
    if leftover:
        logger.warning("unused checkpoint tensors: %s", leftover[:8])
    return Model(
        embed_tokens=embed, blocks=blocks, norm=norm, lm_head=lm_head,
        cfg=model_cfg,
    )
