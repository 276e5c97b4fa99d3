"""Offline checkpoint transformations (publisher tooling).

Port of ``vptq_tpu/tools/checkpoint_tools.py``, the counterparts of the
reference's pack / repack pipeline (reference: vptq/utils/pack.py and
vptq/tools/pre_process.py):

  * ``absorb_perm``       — fold the input permutation into index order
    and disable ``enable_perm`` (reference pack.py:284-433).
  * ``pack_checkpoint``   — merge separate main / residual index planes
    into the bit-packed int32 stream (reference ``convert_idx_dtype``,
    pack.py:147-242).
  * ``unpack_checkpoint`` — inverse: packed stream → separate
    uint16-viewed planes (the v2-kernel format).

The transforms work on a state dict of tensors on one device (the card
unless the caller asks for the CPU), read by the loader's own readers
(safetensors, or ``pytorch_model*.bin``) and written by its safetensors
writer; the files are byte for byte the JAX package's.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict

import torch

from vptq_tpu_torch.config import QuantizationConfig
from vptq_tpu_torch.models.loader import (
    load_state_dict,
    resolve_device,
    write_safetensors,
)
from vptq_tpu_torch.ops.packing import pack_index, unpack_index, view_as_uint16

logger = logging.getLogger("vptq_tpu_torch")

__all__ = [
    "load_raw_state",
    "save_state",
    "absorb_perm",
    "pack_checkpoint",
    "unpack_checkpoint",
    "resolve_layer_prefix",
]


def resolve_layer_prefix(state, config) -> str:
    """Tensor-name prefix between state-dict keys and
    ``config_for_layers`` names.

    Wrapper checkpoints nest the transformer under an extra module path,
    e.g. SentenceTransformer stores it as ``0.auto_model.<name>`` (the
    reference navigates ``model[0].auto_model`` in ``pack_model``,
    reference pack.py:269-281). Returns "" for plain checkpoints.
    """
    qcfg = QuantizationConfig.from_dict(config.get("quantization_config", {}))
    names = list(qcfg.config_for_layers)
    if not names:
        return ""
    probe = f"{names[0]}.indices"
    if probe in state:
        return ""
    for key in state:
        if key.endswith("." + probe):
            return key[: -len(probe)]
    raise KeyError(
        f"cannot locate {probe!r} in checkpoint state "
        "(unknown wrapper layout)"
    )


def load_raw_state(checkpoint_dir: str, device=None):
    """(state dict of tensors on ``device``, hf config dict). ``device``:
    CUDA unless given."""
    device = resolve_device(device)
    root = Path(checkpoint_dir)
    with open(root / "config.json") as f:
        config = json.load(f)
    state: Dict[str, torch.Tensor] = {
        k: v.to(device) for k, v in load_state_dict(str(root)).items()
    }
    return state, config


def save_state(state, config, out_dir: str) -> Path:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_safetensors(dict(state), out / "model.safetensors")
    with open(out / "config.json", "w") as f:
        json.dump(config, f, indent=2)
    return out


def _iter_vq_layers(config):
    qcfg = QuantizationConfig.from_dict(config.get("quantization_config", {}))
    yield from qcfg.config_for_layers.items()


def _as_uint16(ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """ids below 2^16 as uint16 bit patterns viewed as ``dtype`` (numpy's
    ``astype(np.uint16).view(dtype)``)."""
    ids = ids.to(torch.int64) & 0xFFFF
    return torch.where(ids >= 0x8000, ids - 0x10000, ids).to(
        torch.int16
    ).view(dtype)


def _planes(raw: torch.Tensor, layer_cfg) -> torch.Tensor:
    """A separate index plane (uint16 pattern) as (C, N, G) int64 ids."""
    return view_as_uint16(raw).to(torch.int64).reshape(
        layer_cfg.num_codebooks, layer_cfg.num_indices, layer_cfg.group_size
    )


def _packed(raw: torch.Tensor, layer_cfg) -> torch.Tensor:
    """A packed index stream as (C, N, packed_group_size) int32 words."""
    return raw.view(torch.int32).reshape(
        layer_cfg.num_codebooks,
        layer_cfg.num_indices,
        layer_cfg.packed_group_size,
    )


def absorb_perm(state, config):
    """Fold perms into index order; returns (state, config) modified.

    Matches the reference (pack.py:284-394): skips layers with more than
    one codebook; only valid when the index row covers the full
    in_features (no outlier component).
    """
    qc = config.get("quantization_config", {})
    layers = qc.get("config_for_layers", {})
    prefix = resolve_layer_prefix(state, config)
    n_absorbed = 0
    for name, layer_cfg in list(_iter_vq_layers(config)):
        if not layer_cfg.enable_perm:
            continue
        if layer_cfg.num_codebooks > 1:
            logger.debug("%s: group_num > 1, skipping absorption", name)
            continue
        if layer_cfg.enable_outlier:
            logger.debug("%s: outliers present, skipping absorption", name)
            continue

        perm = view_as_uint16(state.pop(f"{prefix}{name}.perm"))
        inv_perm = torch.argsort(perm.to(torch.int64))

        idx_key = f"{prefix}{name}.indices"
        if layer_cfg.is_indice_packed:
            packed = _packed(state[idx_key], layer_cfg)
            main, res = unpack_index(
                packed,
                layer_cfg.index_bits,
                layer_cfg.group_size,
                layer_cfg.res_index_bits,
            )
            main = main[..., inv_perm]
            if res is not None:
                res = res[..., inv_perm]
            repacked = pack_index(
                main, layer_cfg.index_bits, res, layer_cfg.res_index_bits
            )
            if repacked.shape != packed.shape:
                raise ValueError(
                    f"{name}: repacked shape {tuple(repacked.shape)} != "
                    f"{tuple(packed.shape)}"
                )
            state[idx_key] = repacked.reshape(state[idx_key].shape)
        else:
            res_key = f"{prefix}{name}.res_indices"
            for key in (idx_key, res_key) if res_key in state else (idx_key,):
                raw = state[key]
                ids = _planes(raw, layer_cfg)[..., inv_perm]
                state[key] = _as_uint16(ids, raw.dtype).reshape(raw.shape)

        layers[name]["enable_perm"] = False
        n_absorbed += 1
    # shared_layer_config parity (reference pack.py:425-431)
    for conf in qc.get("shared_layer_config", {}).values():
        if isinstance(conf, dict) and conf.get("enable_perm"):
            conf["enable_perm"] = False
    logger.info("absorbed perm in %d layers", n_absorbed)
    return state, config


def pack_checkpoint(state, config):
    """Separate uint16 planes → packed int32 stream per layer (publisher
    flow, reference convert_idx_dtype pack.py:147-242)."""
    qc = config.get("quantization_config", {})
    layers = qc.get("config_for_layers", {})
    prefix = resolve_layer_prefix(state, config)
    for name, layer_cfg in list(_iter_vq_layers(config)):
        if layer_cfg.is_indice_packed:
            continue
        idx_key = f"{prefix}{name}.indices"
        res_key = f"{prefix}{name}.res_indices"
        main = _planes(state[idx_key], layer_cfg)
        res = None
        if res_key in state:
            res = _planes(state.pop(res_key), layer_cfg)
        state[idx_key] = pack_index(
            main,
            layer_cfg.index_bits,
            res,
            layer_cfg.res_index_bits if res is not None else 0,
        )
        layers[name]["is_indice_packed"] = True
    return state, config


def unpack_checkpoint(state, config):
    """Packed int32 stream → separate uint16-viewed planes."""
    qc = config.get("quantization_config", {})
    layers = qc.get("config_for_layers", {})
    prefix = resolve_layer_prefix(state, config)
    for name, layer_cfg in list(_iter_vq_layers(config)):
        if not layer_cfg.is_indice_packed:
            continue
        idx_key = f"{prefix}{name}.indices"
        main, res = unpack_index(
            _packed(state[idx_key], layer_cfg),
            layer_cfg.index_bits,
            layer_cfg.group_size,
            layer_cfg.res_index_bits,
        )
        state[idx_key] = _as_uint16(main, torch.int16)
        if res is not None:
            state[f"{prefix}{name}.res_indices"] = _as_uint16(
                res, torch.int16
            )
        layers[name]["is_indice_packed"] = False
        layers[name]["indices_as_float"] = False
    return state, config
