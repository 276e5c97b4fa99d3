"""Nearest-centroid re-quantization of dense weights.

Port of ``vptq_tpu/tools/requantize.py``, the counterpart of the
reference's ``set_l2_indices`` debug / finetune helper (reference:
vqlinear.py:455-483): given a dense weight matrix and a layer's existing
codebooks, find the L2-nearest main (and residual) centroid indices, for
diagnostics and for re-quantizing fine-tuned weights against published
codebooks. Batched on the tensors' device: one f32 product per batch of
vectors (without TF32) and an argmin, which keeps the first index on a
tie as numpy's does. Sums in another order than numpy's can still part
from it on a near tie.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vptq_tpu_torch.config import VQLinearConfig
from vptq_tpu_torch.quant.gptq import true_f32

__all__ = ["nearest_indices", "requantize"]


def nearest_indices(
    vectors: torch.Tensor,  # (N, v)
    centroids: torch.Tensor,  # (K, v)
    batch_size: int = 16384,
) -> torch.Tensor:
    """argmin_k ||vec - centroid_k||^2 per vector (batched), int64."""
    vectors = vectors.to(torch.float32)
    centroids = centroids.to(device=vectors.device, dtype=torch.float32)
    c_sq = torch.sum(centroids ** 2, dim=1)  # (K,)
    out = torch.empty(len(vectors), dtype=torch.int64, device=vectors.device)
    with true_f32():
        for start in range(0, len(vectors), batch_size):
            vb = vectors[start: start + batch_size]
            # ||v - c||^2 = ||v||^2 - 2 v.c + ||c||^2, ||v||^2 constant a
            # row: c_sq - 2 v.c in one product
            dist = torch.addmm(c_sq[None, :], vb, centroids.t(), alpha=-2)
            out[start: start + len(vb)] = torch.argmin(dist, dim=1)
    return out


def requantize(
    weight: torch.Tensor,  # (out, in): pre-norm weight (no scale / bias)
    centroids: torch.Tensor,  # (C, K, v)
    res_centroids: Optional[torch.Tensor],  # (C, Kr, v)
    cfg: VQLinearConfig,
    batch_size: int = 16384,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """L2-nearest (main_ids, res_ids) for ``weight``, each (1, num_indices,
    in_features) int64 on the weight's device.

    Only the single-codebook, no-outlier case is supported (the reference
    helper, vqlinear.py:455-483, indexes codebook 0). Weight rows are
    grouped into ``vector_len`` vectors along out_features, padded as in
    the checkpoint layout.
    """
    if cfg.num_codebooks != 1:
        raise NotImplementedError("requantize supports one codebook")
    if cfg.enable_outlier:
        raise NotImplementedError("outlier requantization unsupported")

    v = cfg.vector_len
    w = weight.to(torch.float32)
    if cfg.padding:
        w = F.pad(w, (0, 0, 0, cfg.padding))
    # (out_padded, in) -> vectors along out: (in * out / v, v)
    vecs = w.t().contiguous().reshape(-1, v)

    main = nearest_indices(vecs, centroids[0], batch_size)
    res = None
    if res_centroids is not None:
        c0 = centroids[0].to(device=vecs.device, dtype=torch.float32)
        res = nearest_indices(vecs - c0[main], res_centroids[0], batch_size)

    # vectors are ordered (in, out_vec): transpose to (out_vec, in)
    main = main.reshape(cfg.in_features, cfg.num_indices).t()[None]
    if res is not None:
        res = res.reshape(cfg.in_features, cfg.num_indices).t()[None]
    return main, res
