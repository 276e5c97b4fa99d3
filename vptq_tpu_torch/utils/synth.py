"""Seeded synthetic VPTQ layer geometry and planes.

Port of ``make_config`` and ``make_numpy_planes`` from
``vptq_tpu/utils/synth.py``: the same numpy draws in the same order, so
one seed gives the same planes in both packages.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from vptq_tpu_torch.config import VQLinearConfig

__all__ = ["make_config", "make_numpy_planes"]


def make_config(
    in_features: int = 256,
    out_features: int = 128,
    vector_len: int = 8,
    num_centroids: int = 256,
    num_res_centroids: int = -1,
    num_codebooks: int = 1,
    outlier_size: int = 0,
    outlier_vector_len: int = -1,
    num_outlier_centroids: int = -1,
    enable_norm: bool = False,
    enable_perm: bool = False,
    is_indice_packed: bool = False,
    bias: bool = False,
) -> VQLinearConfig:
    inlier = in_features - max(outlier_size, 0)
    if inlier % num_codebooks:
        raise ValueError("inlier columns must divide num_codebooks")
    return VQLinearConfig(
        in_features=in_features,
        out_features=out_features,
        vector_lens=(outlier_vector_len, vector_len),
        num_centroids=(num_outlier_centroids, num_centroids),
        num_res_centroids=(-1, num_res_centroids),
        group_num=num_codebooks,
        group_size=inlier // num_codebooks,
        outlier_size=outlier_size,
        indices_as_float=False,
        enable_norm=enable_norm,
        enable_perm=enable_perm,
        is_indice_packed=is_indice_packed,
        bias=bias,
    )


def _plane_dtype(num_centroids: int):
    return np.uint8 if num_centroids <= 256 else np.uint16


def make_numpy_planes(
    cfg: VQLinearConfig,
    seed: int = 1234,
    dtype=np.float32,
    mean: float = 2e-2,
    std: float = 0.5,
) -> Dict[str, Optional[np.ndarray]]:
    """Random normalized parameter planes for one layer (Gaussian
    codebooks of the given ``mean`` and ``std``)."""
    rng = np.random.default_rng(seed)

    def normal(shape):
        return (mean + std * rng.standard_normal(shape)).astype(dtype)

    c, k, v = cfg.num_codebooks, cfg.num_main_centroids, cfg.vector_len
    planes: Dict[str, Optional[np.ndarray]] = {
        "centroids": normal((c, k, v)),
        "ids": rng.integers(
            0, k, size=(c, cfg.num_indices, cfg.group_size)
        ).astype(_plane_dtype(k)),
        "res_centroids": None,
        "res_ids": None,
        "outlier_centroids": None,
        "outlier_ids": None,
        "perm": None,
        "weight_scale": None,
        "weight_bias": None,
        "bias": None,
    }
    if cfg.enable_residual:
        kr = cfg.num_main_res_centroids
        planes["res_centroids"] = normal((c, kr, v))
        planes["res_ids"] = rng.integers(
            0, kr, size=(c, cfg.num_indices, cfg.group_size)
        ).astype(_plane_dtype(kr))
    if cfg.enable_outlier:
        ko, vo = cfg.num_outlier_centroids, cfg.outlier_vector_len
        planes["outlier_centroids"] = normal((1, ko, vo))
        planes["outlier_ids"] = rng.integers(
            0, ko, size=(1, cfg.outlier_num_indices, cfg.outlier_size)
        ).astype(_plane_dtype(ko))
    if cfg.enable_perm:
        planes["perm"] = rng.permutation(cfg.in_features).astype(np.uint16)
    if cfg.enable_norm:
        planes["weight_scale"] = (
            1.0 + 0.1 * rng.standard_normal(cfg.in_features)
        ).astype(dtype)
        planes["weight_bias"] = (
            0.05 * rng.standard_normal(cfg.in_features)
        ).astype(dtype)
    if cfg.bias:
        planes["bias"] = normal((cfg.out_features,))
    return planes
