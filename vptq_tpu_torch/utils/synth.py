"""Seeded synthetic VPTQ layer geometry and planes, and synthetic mixed
models.

Port of ``make_config`` and ``make_numpy_planes`` from
``vptq_tpu/utils/synth.py``: the same numpy draws in the same order, so
one seed gives the same planes in both packages. :func:`mixed_model` is
the calibrated-format stand-in of the JAX package's ``bench.py``
(uniformly spread side columns, random codes), made on the device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from vptq_tpu_torch.config import VQLinearConfig
from vptq_tpu_torch.layers.runtime import (
    INT2_MIXED_COL_FRACTION,
    INT3_MIXED_COL_FRACTION,
)

__all__ = [
    "MIXED_FORMATS", "make_config", "make_numpy_planes", "mixed_cols",
    "mixed_model",
]

# mixed format -> (its base format, the int8 side's share of the columns)
MIXED_FORMATS = {
    "int2-mixed": ("int2", INT2_MIXED_COL_FRACTION),
    "int3-mixed": ("int3", INT3_MIXED_COL_FRACTION),
}


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
    heavy_tailed: bool = False,
) -> Dict[str, Optional[np.ndarray]]:
    """Random normalized parameter planes for one layer (Gaussian
    codebooks of the given ``mean`` and ``std``).

    ``heavy_tailed``: statistics like a real LLM's instead: codebook
    components from Student-t(4) rescaled by √2 (variance matched to the
    Gaussian's), and a lognormal (σ 0.5) ``weight_scale`` whose
    ``max(4, in / 128)`` randomly chosen channels are boosted 4–10×.
    """
    rng = np.random.default_rng(seed)

    def normal(shape):
        if heavy_tailed:
            # t(4) has variance 2
            t = rng.standard_t(4, size=shape) / np.sqrt(2.0)
            return (mean + std * t).astype(dtype)
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
        if heavy_tailed:
            ws = np.exp(0.5 * rng.standard_normal(cfg.in_features))
            n_out = max(4, cfg.in_features // 128)
            boosted = rng.choice(cfg.in_features, n_out, replace=False)
            ws[boosted] *= rng.uniform(4.0, 10.0, n_out)
            planes["weight_scale"] = ws.astype(dtype)
        else:
            planes["weight_scale"] = (
                1.0 + 0.1 * rng.standard_normal(cfg.in_features)
            ).astype(dtype)
        planes["weight_bias"] = (
            0.05 * rng.standard_normal(cfg.in_features)
        ).astype(dtype)
    if cfg.bias:
        planes["bias"] = normal((cfg.out_features,))
    return planes


def mixed_cols(in_features: int, fraction: float) -> int:
    """The int8 side's column count at one site, by calibration's rule:
    ``max(128, round(in · fraction))`` rounded up to a multiple of 128, at
    most ``in``."""
    k = max(128, int(round(in_features * fraction)))
    return min(-(-k // 128) * 128, in_features)


# the root mean square of uniformly drawn codes' levels: int2 (c + 0.5)
# for c in [-2, 1], int3 c in [-4, 3], int8 c in [-127, 127]
_LEVEL_RMS = {
    "int2": 1.25 ** 0.5, "int3": 5.5 ** 0.5, "int8": (127 * 128 / 3) ** 0.5,
}


def _scales(shape, fmt: str, std: float, gen) -> torch.Tensor:
    """f32 scales that give levels of ``fmt`` a spread about ``std``
    (uniform in [0.5, 1.5) of it), bf16-representable."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return ((0.5 + u) * (std / _LEVEL_RMS[fmt])).to(torch.bfloat16).float()


def _mixed_linear(fmt: str, in_f: int, out_f: int, gen, std: float):
    """One mixed site: random base codes, and an int8 side on
    ``mixed_cols`` columns spread evenly over ``in_f``, with scale group
    128 as calibration makes it; the side's entries are of the base's
    order."""
    from vptq_tpu_torch.layers import runtime as rt
    from vptq_tpu_torch.ops.packing import INT4_GROUP, W2_GROUP

    device = gen.device
    base, fraction = MIXED_FORMATS[fmt]
    lo, group = (-2, W2_GROUP) if base == "int2" else (-4, INT4_GROUP)
    q = torch.randint(lo, -lo, (out_f, in_f), generator=gen, device=device,
                      dtype=torch.int8)
    # whole scale groups, as calibration pads a width that has none
    q = torch.nn.functional.pad(q, (0, (-in_f) % group))
    s = _scales((out_f, q.shape[1] // group), base, std, gen)
    base_layer = getattr(rt, f"{base}_from_q")(q, s)
    k = mixed_cols(in_f, fraction)
    q8 = torch.randint(-127, 128, (out_f, k), generator=gen, device=device,
                       dtype=torch.int8)
    # fewer than 128 columns (a tiny model) fill one zero-padded group
    q8 = torch.nn.functional.pad(q8, (0, (-k) % 128))
    side = rt.int8_from_q(
        q8, _scales((out_f, q8.shape[1] // 128), "int8", std, gen))
    cols = torch.from_numpy(np.linspace(0, in_f - 1, k).astype(np.int32))
    kind = rt.Int2MixedLinear if base == "int2" else rt.Int3MixedLinear
    return kind(base_layer, side, cols.to(device))


def mixed_model(cfg, fmt: str, device, seed: int = 0, std: float = 0.02,
                dtype=torch.bfloat16):
    """A dense Llama-family :class:`~vptq_tpu_torch.models.llama.Model` of
    ``cfg`` in ``fmt`` ("int2-mixed" or "int3-mixed") with random weights
    of spread ``std`` made on ``device``: fused q|k|v and gate|up sites
    (one column selection each), unit norms, a bf16 embedding and a dense
    bf16 lm_head."""
    from vptq_tpu_torch.layers.dense import DenseLinear
    from vptq_tpu_torch.models.llama import Attention, Block, Mlp, Model

    if cfg.num_local_experts:
        raise NotImplementedError("mixed_model builds dense models")
    gen = torch.Generator(device=device).manual_seed(seed)
    h, inter = cfg.hidden_size, cfg.intermediate_size
    heads = cfg.num_attention_heads * cfg.head_dim
    qkv = heads + 2 * cfg.num_key_value_heads * cfg.head_dim

    def lin(in_f, out_f):
        return _mixed_linear(fmt, in_f, out_f, gen, std)

    def ones():
        return torch.ones(h, dtype=torch.float32, device=device)

    def normal(shape):
        return (torch.randn(shape, generator=gen, device=device) * std).to(
            dtype)

    blocks = [
        Block(
            input_layernorm=ones(),
            attn=Attention(None, None, None, o_proj=lin(heads, h),
                           qkv_proj=lin(h, qkv)),
            post_attention_layernorm=ones(),
            mlp=Mlp(None, None, down_proj=lin(inter, h),
                    gate_up_proj=lin(h, 2 * inter)),
        )
        for _ in range(cfg.num_hidden_layers)
    ]
    return Model(
        embed_tokens=normal((cfg.vocab_size, h)), blocks=blocks, norm=ones(),
        lm_head=DenseLinear(normal((cfg.vocab_size, h))), cfg=cfg,
    )
