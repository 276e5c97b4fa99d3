"""VPTQ weight reconstruction in torch (the correctness anchor).

Port of ``vptq_tpu/ops/dequant.py``, which re-implements op for op the
reference's pure-torch fallback ``dequant`` (reference:
vptq/ops/quant_gemm.py:43-158). Here it is a torch gather that runs on
the device the tensors lie on; the loader runs it once per layer on
the card to re-encode the weights.

Index planes must already be int64 ids (``ops.packing.widen_index``).
"""

from __future__ import annotations

from typing import Optional

import torch

from vptq_tpu_torch.config import VQLinearConfig

__all__ = ["dequant_weight", "reconstruct_main", "reconstruct_outlier"]


def _gather_vectors(codebook: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather codebook vectors and lay them out as weight rows.

    codebook (C, K, v); ids (C, rows, group_size) int64.
    Returns (rows * v, C * group_size): entry [o, c*G+g] is
    ``codebook[c, ids[c, o // v, g], o % v]``.
    """
    num_codebooks, rows, group_size = ids.shape
    k, v = codebook.shape[1], codebook.shape[2]
    offsets = torch.arange(
        num_codebooks, device=ids.device, dtype=torch.int64
    ).view(-1, 1, 1) * k
    # (C, rows, G, v)
    selected = codebook.reshape(num_codebooks * k, v)[ids + offsets]
    # rows of W run along out_features in vectors of length v
    # (vector_quant_dim == "out")
    selected = selected.permute(0, 1, 3, 2).reshape(
        num_codebooks, rows * v, group_size
    )
    return selected.permute(1, 0, 2).reshape(
        rows * v, num_codebooks * group_size
    )


def reconstruct_main(centroids, ids, res_centroids, res_ids, cfg):
    """Main (+ residual) block, padding rows removed: (out, C * G)."""
    qweight = _gather_vectors(centroids, ids)
    if cfg.enable_residual:
        qweight = qweight + _gather_vectors(res_centroids, res_ids)
    if cfg.padding > 0:
        qweight = qweight[: -cfg.padding, :]
    return qweight


def reconstruct_outlier(outlier_centroids, outlier_ids, cfg):
    """Outlier block (out, outlier_size), put in front of the main one."""
    block = _gather_vectors(outlier_centroids, outlier_ids)
    if cfg.outlier_padding > 0:
        block = block[: -cfg.outlier_padding, :]
    return block


def dequant_weight(
    centroids: torch.Tensor,
    ids: torch.Tensor,
    res_centroids: Optional[torch.Tensor] = None,
    res_ids: Optional[torch.Tensor] = None,
    outlier_centroids: Optional[torch.Tensor] = None,
    outlier_ids: Optional[torch.Tensor] = None,
    inv_perm: Optional[torch.Tensor] = None,
    weight_scale: Optional[torch.Tensor] = None,
    weight_bias: Optional[torch.Tensor] = None,
    *,
    cfg: VQLinearConfig,
) -> torch.Tensor:
    """Reconstruct the full weight ``W`` of shape (out, in).

    ``inv_perm`` is the inverse permutation (argsort of the stored
    ``perm``). The norm is a multiply and then a separate add, never a
    fused multiply-add, so the result is bit-equal to the JAX package's.
    """
    qweight = reconstruct_main(centroids, ids, res_centroids, res_ids, cfg)
    if cfg.enable_outlier:
        outlier_block = reconstruct_outlier(
            outlier_centroids, outlier_ids, cfg
        )
        qweight = torch.cat([outlier_block, qweight], dim=1)
    if inv_perm is not None:
        qweight = qweight[:, inv_perm]
    if cfg.enable_norm:
        qweight = qweight * weight_scale[None, :]
        qweight = qweight + weight_bias[None, :]
    return qweight
