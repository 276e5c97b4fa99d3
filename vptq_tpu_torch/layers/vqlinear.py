"""Vector-quantized linear layer; port of ``vptq_tpu/layers/vqlinear.py``.

Holds the normalized planes of one VPTQ layer: codebooks, index planes
(uint8, or the uint16 bit pattern as int16; see ``ops.packing``), the
inverse input permutation and the per-input-channel norm. Calling it
runs the ``codebook`` format: dequantize, then one matmul.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vptq_tpu_torch.config import VQLinearConfig
from vptq_tpu_torch.ops.quant_matmul import quant_matmul

__all__ = ["VQLinear"]


class VQLinear(nn.Module):
    def __init__(
        self,
        centroids: torch.Tensor,  # (num_codebooks, num_centroids, vector_len)
        ids: torch.Tensor,  # (num_codebooks, num_indices, group_size)
        res_centroids: Optional[torch.Tensor] = None,
        res_ids: Optional[torch.Tensor] = None,
        outlier_centroids: Optional[torch.Tensor] = None,
        outlier_ids: Optional[torch.Tensor] = None,
        inv_perm: Optional[torch.Tensor] = None,  # int64 (in_features,)
        weight_scale: Optional[torch.Tensor] = None,
        weight_bias: Optional[torch.Tensor] = None,
        bias: Optional[torch.Tensor] = None,
        *,
        cfg: VQLinearConfig,
    ):
        super().__init__()
        planes = dict(
            centroids=centroids, ids=ids, res_centroids=res_centroids,
            res_ids=res_ids, outlier_centroids=outlier_centroids,
            outlier_ids=outlier_ids, inv_perm=inv_perm,
            weight_scale=weight_scale, weight_bias=weight_bias, bias=bias,
        )
        for name, value in planes.items():
            self.register_buffer(name, value)
        self.cfg = cfg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant_matmul(x, self)

    @property
    def in_features(self) -> int:
        return self.cfg.in_features

    @property
    def out_features(self) -> int:
        return self.cfg.out_features
