"""The ``codebook`` runtime format's matmul: dequantize, then one matmul.

Port of ``vptq_tpu/ops/quant_matmul.py:50-110``. The JAX package runs
this format as an XLA gather plus a dot; here it is the torch gather of
:mod:`vptq_tpu_torch.ops.dequant` plus ``torch.matmul``. It is exact
and keeps the compressed weights, but gathers the whole matrix on every
call: the fast path is the int8 format (``layers/runtime.py``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from vptq_tpu_torch.ops.dequant import dequant_weight
from vptq_tpu_torch.ops.packing import widen_index

if TYPE_CHECKING:  # pragma: no cover
    from vptq_tpu_torch.layers.vqlinear import VQLinear

__all__ = ["layer_weight", "quant_matmul"]


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


def _ids(t):
    return None if t is None else widen_index(t)


def layer_weight(layer: "VQLinear", dtype: torch.dtype) -> torch.Tensor:
    """The layer's full weight (out, in), its planes cast to ``dtype``."""
    return dequant_weight(
        centroids=layer.centroids.to(dtype),
        ids=widen_index(layer.ids),
        res_centroids=_cast(layer.res_centroids, dtype),
        res_ids=_ids(layer.res_ids),
        outlier_centroids=_cast(layer.outlier_centroids, dtype),
        outlier_ids=_ids(layer.outlier_ids),
        inv_perm=layer.inv_perm,
        weight_scale=_cast(layer.weight_scale, dtype),
        weight_bias=_cast(layer.weight_bias, dtype),
        cfg=layer.cfg,
    )


def quant_matmul(x: torch.Tensor, layer: "VQLinear") -> torch.Tensor:
    """``x @ W^T + bias`` for a VPTQ layer; (..., in) -> (..., out)."""
    cfg = layer.cfg
    if x.shape[-1] != cfg.in_features:
        raise ValueError(
            f"activation dim {x.shape[-1]} != in_features {cfg.in_features}"
        )
    out = torch.matmul(x, layer_weight(layer, x.dtype).t())
    if layer.bias is not None:
        out = out + layer.bias.to(out.dtype)
    return out
