"""HF checkpoint ingestion: VPTQ safetensors (or ``.bin``) → runtime modules.

Port of ``vptq_tpu/models/loader.py`` for dense Llama (Phi-3's fused
layout too), Mixtral and DeepSeek-V3 (MLA, whose kv_b_proj is read raw
and absorbed into uk / uv, never re-encoded; the grouped MoE with shared
experts) on one device.
The safetensors format is read directly (8-byte header length, JSON
header, raw little-endian bytes; bf16 included) with ``torch.frombuffer``
on a memory map, so no package beyond torch is needed; a checkpoint with
no safetensors is read from its ``pytorch_model*.bin`` pickles. Each
quantized layer is moved to the load device as stored, then normalized
there:

  * the uint16-viewed-as-float16/int16 dtype trick is undone
    (reference vqlinear.py:110-113) by ``ops.packing.view_as_uint16``,
    which stands for the JAX loader's ``_to_numpy_intview``,
  * bit-packed int32 index streams are unpacked word by word,
  * the input permutation is inverted once,
  * codebooks, norm scale and bias are cast to the load dtype before
    the f32 dequant, as the JAX package does,

and re-encoded to the requested runtime format (``layers/runtime.py``).

With a ``mesh`` (``parallel/mesh.py``) each rank loads its own shard of
the model for tensor and expert parallelism: the row-parallel layers are
encoded blocked straight from the exact weights, and each block is placed
as it is built (``parallel/tp.py`` ``tp_place_block``), so that the rank
keeps only its shard and no block but the one being built exists whole.
"""

from __future__ import annotations

import json
import logging
import mmap
import os
import sys
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from vptq_tpu_torch.config import QuantizationConfig, VQLinearConfig
from vptq_tpu_torch.layers.dense import DenseLinear
from vptq_tpu_torch.layers.runtime import (
    RUNTIME_FORMATS,
    absorb_mla,
    dense_to_int8,
    fuse_block,
    to_runtime,
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
)
from vptq_tpu_torch.ops.packing import (
    to_index_plane,
    unpack_index,
    view_as_uint16,
)
from vptq_tpu_torch.parallel.tp import (
    _col_parallel,
    place_embedding,
    tp_place_block,
)

logger = logging.getLogger("vptq_tpu_torch")

__all__ = [
    "load_model",
    "load_state_dict",
    "normalize_vq_layer",
    "entry_device",
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
# the safetensors package's dtype order (its Rust enum), which orders the
# tensors of a file it writes
_SAFETENSORS_RANK = {
    _SAFETENSORS_DTYPES[code]: rank for rank, code in enumerate((
        "BOOL", "U8", "I8", "I16", "U16", "F16", "BF16", "I32", "U32",
        "F32", "F64", "I64", "U64",
    ))
}
# the formats that exist only calibrated (an int8 side: sites or columns)
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


def entry_device(device: str) -> torch.device:
    """The device a command-line entry point runs on (its ``--device``,
    ``cuda`` unless the caller asks for the CPU); exits non-zero when
    CUDA is asked for and there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"{sys.argv[0]}: no CUDA device is available; pass --device cpu "
            "to run on the CPU"
        )
    return resolve_device(dev)


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
    # the safetensors package's order (its dtype order, descending, then
    # the name), so that the file is byte for byte the one it writes; the
    # larger elements come first, which keeps every tensor aligned
    items.sort(key=lambda kv: (-_SAFETENSORS_RANK[kv[1].dtype], kv[0]))
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


def _shards(root: Path, suffix: str, pattern: str):
    """The shards an ``*{suffix}.index.json`` map names, else the files
    matching ``pattern``."""
    index_files = sorted(root.glob(f"*{suffix}.index.json"))
    if index_files:
        with open(index_files[0]) as f:
            weight_map = json.load(f)["weight_map"]
        return sorted({root / v for v in weight_map.values()})
    return sorted(root.glob(pattern))


def load_state_dict(checkpoint_dir: str) -> Dict[str, torch.Tensor]:
    """Read all checkpoint shards as CPU tensors: safetensors first
    (``*.index.json`` maps honoured), else the ``pytorch_model*.bin``
    pickles (``*.bin.index.json`` maps honoured), each through
    ``torch.load(weights_only=True)``; bf16 stays bf16."""
    root = Path(checkpoint_dir)
    shards = _shards(root, ".safetensors", "*.safetensors")
    state: Dict[str, torch.Tensor] = {}
    if shards:
        for shard in shards:
            state.update(_read_safetensors(shard))
        return state
    shards = _shards(root, ".bin", "pytorch_model*.bin")
    if not shards:
        raise FileNotFoundError(
            f"no safetensors or pytorch_model*.bin found in {root}"
        )
    for shard in shards:
        state.update(
            torch.load(shard, map_location="cpu", weights_only=True)
        )
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
        # int32, as the JAX package holds it (utils/memory.py counts it so)
        inv_perm = torch.argsort(
            view_as_uint16(perm_raw).to(torch.int64)
        ).to(torch.int32)

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
    if cfg.num_local_experts and cfg.model_type != "mixtral":
        missing.append(f"MoE of model_type {cfg.model_type!r}")
    if cfg.n_routed_experts and not cfg.is_mla:
        missing.append("DeepSeek's MoE without MLA")
    if cfg.model_type == "phimoe":
        missing.append("Phi-3.5-MoE (phimoe)")
    if missing:
        raise NotImplementedError(
            "vptq_tpu_torch runs dense Llama, Mistral, Qwen2, Phi-3, "
            "Mixtral and DeepSeek-V3; not ported yet: "
            + ", ".join(missing)
        )


def load_model(
    checkpoint_dir: str,
    dtype=torch.bfloat16,
    runtime_format: str = "codebook",
    fuse: bool = True,
    quantize_lm_head: bool = False,
    device=None,
    calibration=None,
    int8_fraction: Optional[float] = None,
    hbm_gb: Optional[float] = None,
    hbm_utilization: float = 0.9,
    mesh=None,
) -> Model:
    """Load a local VPTQ HF checkpoint directory into a :class:`Model`.

    ``runtime_format``: "codebook" keeps the compressed VQ layers;
    "int8", "int4", "int3", "int2" and "bf16" re-encode each layer once
    (``layers/runtime.py``), leaving dense layers such as the lm_head
    as they are.
    ``fuse`` merges q|k|v and gate|up (dense formats only) and stacks
    the experts of a Mixtral or DeepSeek checkpoint (int8 and int4),
    layer by layer, so one layer's experts exist twice at most.
    ``quantize_lm_head`` re-encodes the dense lm_head to int8 too.
    ``device``: CUDA unless given; the weights are normalized and
    re-encoded there, layer by layer.

    ``runtime_format="int4-mixed"``, ``"int3-mixed"`` or ``"int2-mixed"``,
    or ``calibration`` with "int2", "int3", "int4" or "int8": a calibrated
    re-encode (``vptq_tpu_torch.quant``) on ``device``: the model is
    loaded exact (codebook, unfused), then GPTQ-quantized block by block
    against calibration activations; "int4-mixed" keeps the measured most
    sensitive ``int8_fraction`` of sites in int8, "int3-mixed" /
    "int2-mixed" give each site's most energetic input columns an int8
    side (``int8_fraction``: their share). ``calibration`` is a (B, S)
    token array, an int (that many synthetic tokens) or None (4096
    synthetic tokens).

    ``hbm_gb`` / ``hbm_utilization``: the device's memory budget. The
    loader predicts the model's bytes from the config's geometry BEFORE it
    reads any weight (``utils/memory.py``), logs the format × devices
    budget table and raises :class:`~vptq_tpu_torch.utils.memory.
    HBMBudgetError` when the model and a 2048-token cache do not fit
    ``hbm_utilization`` of it (the reference's ``gpu_utilization`` cap,
    model_base.py:165-181). ``hbm_gb=None`` reads the card's memory, and
    skips the check on the CPU. A calibrated load checks the exact
    (codebook) model it calibrates from, as the JAX package does.

    ``mesh`` (a ``parallel.mesh.Mesh``; every rank calls this with the
    same arguments): the rank's shard for tensor / expert parallelism
    over the mesh's model axis, on ``mesh.device``: the JAX package's
    ``parallel="tp"``. The geometry is validated and the budget checked
    per device of the model axis before anything is read. The codebook
    format is placed as the JAX package's GSPMD placement splits it
    (``parallel/tp.py``: each VQ layer's index planes over the model
    axis; dense geometries). A calibrated format is calibrated once for
    the job, on global rank 0's device, with the row-parallel sites blocked
    (``quantize_model_calibrated(tp_shards=mesh.model)``); each finished
    block goes to every rank (``distributed.broadcast_tensors``) as soon
    as GPTQ is done with it, and each rank keeps its shard of it
    (``tp_place_block(reencode_rows=False)``), so no rank waits longer
    than one block (the ranking pass of "int4-mixed" before the first).
    """
    calibrated = runtime_format in CALIBRATED_FORMATS or (
        calibration is not None
        and runtime_format in ("int2", "int3", "int4", "int8")
    )
    if mesh is not None:
        device = mesh.device
    device = resolve_device(device)
    if calibrated:
        if mesh is not None:
            return _load_calibrated_tp(
                checkpoint_dir, dtype, runtime_format, fuse,
                quantize_lm_head, device, calibration, int8_fraction, hbm_gb,
                hbm_utilization, mesh)
        return _load_calibrated(
            checkpoint_dir, dtype, runtime_format, fuse, quantize_lm_head,
            device, calibration, int8_fraction, hbm_gb, hbm_utilization,
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
    tp_size = 1 if mesh is None else mesh.model
    if mesh is not None:
        from vptq_tpu_torch.parallel.tp import tp_validate

        tp_validate(model_cfg, tp_size,
                    sharded_lm_head=not model_cfg.tie_word_embeddings)
    _check_budget(model_cfg, qcfg, runtime_format, quantize_lm_head, device,
                  hbm_gb, hbm_utilization, tp_size)
    state = load_state_dict(str(root))

    def lin(prefix, row=False):
        # row: a row-parallel layer, blocked under a mesh (a codebook
        # layer has no blocked layout: its placement splits the planes)
        blocked = row and runtime_format != "codebook"
        return to_runtime(
            _linear(prefix, state, qcfg, dtype, device), runtime_format,
            row_shards=tp_size if blocked else 1,
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

    def mlp_at(prefix, row=True):
        # row=False: a routed expert, whole on the rank that holds it
        return Mlp(
            gate_proj=lin(f"{prefix}.gate_proj"),
            up_proj=lin(f"{prefix}.up_proj"),
            down_proj=lin(f"{prefix}.down_proj", row=row),
        )

    def dense_mlp(p):
        return mlp_at(f"{p}.mlp")

    # Phi-3 checkpoints store q|k|v and gate|up fused (qkv_proj,
    # gate_up_proj): each is one layer, re-encoded once, and runs as the
    # fused linear fuse_block would have made
    fused_ckpt = model_cfg.model_type in ("phi3", "phi3_v")

    def fused_mlp(p):
        return Mlp(
            gate_proj=None, up_proj=None,
            down_proj=lin(f"{p}.mlp.down_proj", row=True),
            gate_up_proj=lin(f"{p}.mlp.gate_up_proj"),
        )

    def attention(p):
        if fused_ckpt:
            return Attention(
                q_proj=None, k_proj=None, v_proj=None,
                o_proj=lin(f"{p}.self_attn.o_proj", row=True),
                qkv_proj=lin(f"{p}.self_attn.qkv_proj"),
            )
        return Attention(
            q_proj=lin(f"{p}.self_attn.q_proj"),
            k_proj=lin(f"{p}.self_attn.k_proj"),
            v_proj=lin(f"{p}.self_attn.v_proj"),
            o_proj=lin(f"{p}.self_attn.o_proj", row=True),
        )

    def mla_attention(p):
        p = f"{p}.self_attn"
        if model_cfg.q_lora_rank:
            q_kwargs = dict(
                q_a_proj=lin(f"{p}.q_a_proj"),
                q_a_norm=norm_weight(f"{p}.q_a_layernorm.weight"),
                q_b_proj=lin(f"{p}.q_b_proj"),
            )
        else:
            q_kwargs = dict(q_proj=lin(f"{p}.q_proj"))
        # the raw layer: re-encoding it first would bake avoidable noise
        # into the absorbed products
        uk, uv = absorb_mla(
            _linear(f"{p}.kv_b_proj", state, qcfg, dtype, device),
            model_cfg, dtype,
        )
        return MlaAttention(
            kv_a_proj=lin(f"{p}.kv_a_proj_with_mqa"),
            kv_a_norm=norm_weight(f"{p}.kv_a_layernorm.weight"),
            o_proj=lin(f"{p}.o_proj", row=True), uk=uk, uv=uv, **q_kwargs,
        )

    def deepseek_moe(p, layer_idx):
        # a dense MLP below first_k_dense_replace
        if layer_idx < model_cfg.first_k_dense_replace:
            return dense_mlp(p)
        return DeepseekMoe(
            router_weight=norm_weight(f"{p}.mlp.gate.weight"),
            correction_bias=norm_weight(
                f"{p}.mlp.gate.e_score_correction_bias"
            ),
            experts=[
                mlp_at(f"{p}.mlp.experts.{e}", row=False)
                for e in range(model_cfg.n_routed_experts)
            ],
            shared_experts=mlp_at(f"{p}.mlp.shared_experts"),
            top_k=model_cfg.num_experts_per_tok,
            n_group=model_cfg.n_group,
            topk_group=model_cfg.topk_group,
            norm_topk_prob=model_cfg.norm_topk_prob,
            routed_scaling_factor=model_cfg.routed_scaling_factor,
        )

    deepseek = model_cfg.is_mla
    if deepseek:
        make_attn, make_mlp = mla_attention, deepseek_moe
    elif model_cfg.num_local_experts:
        make_attn, make_mlp = attention, moe_mlp
    else:
        make_attn = attention
        make_mlp = fused_mlp if fused_ckpt else dense_mlp
    blocks = []
    for i in range(model_cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        block = Block(
            input_layernorm=norm_weight(f"{p}.input_layernorm.weight"),
            attn=make_attn(p),
            post_attention_layernorm=norm_weight(
                f"{p}.post_attention_layernorm.weight"
            ),
            mlp=make_mlp(p, i) if deepseek else make_mlp(p),
        )
        if fuse and runtime_format != "codebook":
            fuse_block(block)
        if mesh is not None:
            # the rank keeps its shard; the whole block goes
            block = tp_place_block(block, mesh, model_cfg,
                                   reencode_rows=False)
        blocks.append(block)

    embed = state.pop("model.embed_tokens.weight").to(device).to(dtype)
    norm = norm_weight("model.norm.weight")
    lm_head = None
    if not model_cfg.tie_word_embeddings:
        if "lm_head.weight" in state or qcfg.lookup("lm_head") is not None:
            lm_head = lin("lm_head")
    if quantize_lm_head and isinstance(lm_head, DenseLinear):
        lm_head = dense_to_int8(lm_head)
    if mesh is not None:
        embed = place_embedding(embed, lm_head, mesh)
        if lm_head is not None:
            lm_head = _col_parallel(lm_head, mesh)

    leftover = [k for k in state if "rotary" not in k]
    if leftover:
        logger.warning("unused checkpoint tensors: %s", leftover[:8])
    return Model(
        embed_tokens=embed, blocks=blocks, norm=norm, lm_head=lm_head,
        cfg=model_cfg,
    )


def _check_budget(model_cfg, qcfg, runtime_format, quantize_lm_head, device,
                  hbm_gb, hbm_utilization, tp_size: int = 1) -> None:
    """The budget check of :func:`load_model`, from the geometry alone: the
    weights (blocked over ``tp_size`` shards) and a 2048-token cache over
    the devices of the model axis only (the data axis holds copies)."""
    from vptq_tpu_torch.utils import memory as hbm

    hbm_bytes = (int(hbm_gb * hbm.GiB) if hbm_gb
                 else hbm.detect_hbm_bytes(device))
    if not hbm_bytes:
        return
    est = hbm.estimate_model_bytes(
        model_cfg, runtime_format, qcfg, quantize_lm_head, tp_shards=tp_size
    )
    table = hbm.budget_table(
        model_cfg, qcfg, hbm_bytes=hbm_bytes, utilization=hbm_utilization
    )
    logger.info(
        "HBM budget (per-chip, weights + 2048-token KV):\n%s",
        hbm.format_budget_table(table),
    )
    hbm.check_budget(
        est["total"] + hbm.kv_cache_bytes(model_cfg, 1, 2048),
        tp_size,
        hbm_bytes,
        hbm_utilization,
        what=f"{runtime_format} model ({est['total'] / hbm.GiB:.2f}"
        " GiB weights)",
    )


def _calibration_tokens(calibration, vocab_size: int):
    """``load_model``'s ``calibration``: token ids as given, or that many
    synthetic tokens for an int (None: the calibration's default)."""
    from vptq_tpu_torch.quant.calibrate import synthetic_calibration_tokens

    if isinstance(calibration, (int, np.integer)):
        return synthetic_calibration_tokens(vocab_size,
                                            n_tokens=int(calibration))
    return calibration


def _load_calibrated(checkpoint_dir, dtype, runtime_format, fuse,
                     quantize_lm_head, device, calibration, int8_fraction,
                     hbm_gb, hbm_utilization):
    """The calibrated branch of :func:`load_model`."""
    from vptq_tpu_torch.quant.calibrate import quantize_model_calibrated

    exact = load_model(checkpoint_dir, dtype=dtype, runtime_format="codebook",
                       fuse=False, device=device, hbm_gb=hbm_gb,
                       hbm_utilization=hbm_utilization)
    model, _report = quantize_model_calibrated(
        exact, _calibration_tokens(calibration, exact.cfg.vocab_size),
        fmt=runtime_format, int8_fraction=int8_fraction, fuse=fuse,
    )
    model.lm_head = _calibrated_lm_head(model.lm_head, runtime_format,
                                        quantize_lm_head)
    return model


def _calibrated_lm_head(lm, runtime_format, quantize_lm_head):
    """Only the decoder blocks are re-encoded by calibration: a
    VPTQ-quantized lm_head is converted to the base format here, as the
    plain path would, and a dense one to int8 when asked."""
    if isinstance(lm, VQLinear):
        lm = to_runtime(lm, runtime_format.split("-")[0])
    if quantize_lm_head and isinstance(lm, DenseLinear):
        lm = dense_to_int8(lm)
    return lm


def _load_calibrated_tp(checkpoint_dir, dtype, runtime_format, fuse,
                        quantize_lm_head, device, calibration, int8_fraction,
                        hbm_gb, hbm_utilization, mesh):
    """The calibrated branch under a mesh: global rank 0 calibrates with
    the row-parallel sites blocked over the model axis and hands each
    finished block, then the embedding, the norm and the lm_head, to
    every rank; each rank rebuilds it from the bytes it got (rank 0 too),
    fuses it and keeps its shard."""
    import torch.distributed as dist

    from vptq_tpu_torch.parallel.distributed import broadcast_tensors
    from vptq_tpu_torch.parallel.tp import tp_validate
    from vptq_tpu_torch.quant.calibrate import quantize_model_calibrated
    from vptq_tpu_torch.tools.export_runtime import (
        _flatten_block,
        _put,
        _put_linear,
        _Reader,
    )

    root = Path(checkpoint_dir)
    with open(root / "config.json") as f:
        hf_config = json.load(f)
    model_cfg = ModelConfig.from_hf_dict(hf_config)
    _check_supported(model_cfg)
    qcfg = QuantizationConfig.from_dict(
        hf_config.get("quantization_config", {}))
    n = mesh.model
    tp_validate(model_cfg, n,
                sharded_lm_head=not model_cfg.tie_word_embeddings)
    # int4-mixed's int8 sites are a calibration output: its int4 planes
    # are the part the geometry can tell
    _check_budget(model_cfg, qcfg, {"int4-mixed": "int4"}.get(
        runtime_format, runtime_format), quantize_lm_head, device, hbm_gb,
        hbm_utilization, n)
    blocks = []

    def keep(i, flat):
        block = _Reader(flat, model_cfg, device, shards=n).block(
            f"blocks.{i}")
        if fuse:
            fuse_block(block)
        blocks.append(tp_place_block(block, mesh, model_cfg,
                                     reencode_rows=False))

    if dist.get_rank() == 0:
        exact = load_model(checkpoint_dir, dtype=dtype,
                           runtime_format="codebook", fuse=False,
                           device=device, hbm_gb=hbm_gb,
                           hbm_utilization=hbm_utilization)
        whole, _report = quantize_model_calibrated(
            exact, _calibration_tokens(calibration, exact.cfg.vocab_size),
            fmt=runtime_format, int8_fraction=int8_fraction,
            fuse=False, tp_shards=n,
            on_block=lambda i, b: keep(i, broadcast_tensors(
                _flatten_block({}, f"blocks.{i}", b), device)),
        )
        rest = {}
        _put(rest, "embed_tokens", whole.embed_tokens)
        _put(rest, "norm", whole.norm)
        _put_linear(rest, "lm_head", _calibrated_lm_head(
            whole.lm_head, runtime_format, quantize_lm_head))
        del exact, whole
        rest = broadcast_tensors(rest, device)
    else:
        for i in range(model_cfg.num_hidden_layers):
            keep(i, broadcast_tensors(None, device))
        rest = broadcast_tensors(None, device)
    reader = _Reader(rest, model_cfg, device)
    lm_head = reader.linear("lm_head", model_cfg.hidden_size)
    embed = place_embedding(reader.take("embed_tokens"), lm_head, mesh)
    if lm_head is not None:
        lm_head = _col_parallel(lm_head, mesh)
    return Model(embed_tokens=embed, blocks=blocks,
                 norm=reader.take("norm"), lm_head=lm_head, cfg=model_cfg)
