"""vptq_tpu_torch dequant against vptq_tpu.

``dequant_weight`` must be exactly equal to the JAX package's host
(numpy) path over the residual / outlier / perm / norm / codebook-count
lattice; the ``codebook`` format's matmul agrees within f32 rounding.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import port_layer, tensor

from vptq_tpu.ops.dequant import dequant_weight as j_dequant
from vptq_tpu.utils.synth import make_config, make_numpy_planes, planes_to_layer
from vptq_tpu_torch.config import VQLinearConfig
from vptq_tpu_torch.ops.dequant import dequant_weight as t_dequant

_LATTICE = list(itertools.product([False, True], repeat=4)) + [None]


def _cfg(residual, outlier, perm, norm, codebooks=1):
    return make_config(
        in_features=256,
        out_features=100,  # not a multiple of vector_len: padding rows
        vector_len=8,
        num_centroids=512,
        num_res_centroids=64 if residual else -1,
        num_codebooks=codebooks,
        outlier_size=16 if outlier else 0,
        outlier_vector_len=4 if outlier else -1,
        num_outlier_centroids=32 if outlier else -1,
        enable_norm=norm,
        enable_perm=perm,
    )


def _lattice_cfg(flags):
    if flags is None:  # two codebooks with everything on
        return _cfg(True, True, True, True, codebooks=2)
    return _cfg(*flags)


@pytest.mark.parametrize("flags", _LATTICE)
def test_dequant_weight_exact(flags):
    cfg = _lattice_cfg(flags)
    planes = make_numpy_planes(cfg, seed=11)
    inv_perm = (
        None if planes["perm"] is None
        else np.argsort(planes["perm"].astype(np.int64))
    )

    def ids(name):
        a = planes[name]
        return None if a is None else a.astype(np.int64)

    want = j_dequant(
        centroids=planes["centroids"], ids=ids("ids"),
        res_centroids=planes["res_centroids"], res_ids=ids("res_ids"),
        outlier_centroids=planes["outlier_centroids"],
        outlier_ids=ids("outlier_ids"), inv_perm=inv_perm,
        weight_scale=planes["weight_scale"], weight_bias=planes["weight_bias"],
        cfg=cfg, xp=np,
    )
    tcfg = VQLinearConfig.from_dict(cfg.to_dict())
    got = t_dequant(
        centroids=tensor(planes["centroids"]), ids=tensor(ids("ids")),
        res_centroids=tensor(planes["res_centroids"]), res_ids=tensor(ids("res_ids")),
        outlier_centroids=tensor(planes["outlier_centroids"]),
        outlier_ids=tensor(ids("outlier_ids")), inv_perm=tensor(inv_perm),
        weight_scale=tensor(planes["weight_scale"]),
        weight_bias=tensor(planes["weight_bias"]), cfg=tcfg,
    )
    assert got.shape == (cfg.out_features, cfg.in_features)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("codebooks", [1, 2])
def test_codebook_format_matmul_matches(codebooks):
    cfg = make_config(
        in_features=256, out_features=100, vector_len=8, num_centroids=512,
        num_res_centroids=64, num_codebooks=codebooks, enable_norm=True,
        enable_perm=True, bias=True,
    )
    planes = make_numpy_planes(cfg, seed=5)
    x = np.random.default_rng(0).standard_normal((3, 256)).astype(np.float32)
    want = np.asarray(planes_to_layer(planes, cfg)(jnp.asarray(x)))
    got = port_layer(planes, cfg)(torch.from_numpy(x)).numpy()
    # f32 on both sides: only the dot's summation order differs
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
