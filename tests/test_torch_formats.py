"""vptq_tpu_torch formats against vptq_tpu: config parsing and packing.

Packing and unpacking must be exactly equal, including ids that
straddle an int32 word and residual bits.
"""

import numpy as np
import pytest
import torch

from vptq_tpu import config as jcfg
from vptq_tpu.ops import packing as jpack
from vptq_tpu_torch import config as tcfg
from vptq_tpu_torch.ops import packing as tpack

_QCFG = {
    "quant_method": "vptq",
    "config_for_layers": {
        "model.layers.0.self_attn.q_proj": {
            "in_features": 4096, "out_features": 4096,
            "vector_lens": [-1, 8], "num_centroids": [-1, 65536],
            "num_res_centroids": [-1, 256], "group_num": 1,
            "group_size": 4096, "outlier_size": 0, "enable_norm": True,
            "enable_perm": True, "is_indice_packed": True, "bias": False,
            "unknown_key": 1,
        },
    },
    "shared_layer_config": {
        "down_proj": {
            "in_features": 14336, "out_features": 4096,
            "vector_lens": [4, 6], "num_centroids": [512, 4096],
            "num_res_centroids": [-1, -1], "group_num": 2,
            "group_size": 7000, "outlier_size": 336, "bias": [0.0],
        },
    },
}


@pytest.mark.parametrize(
    "path",
    [
        "model.layers.0.self_attn.q_proj",
        "model.layers.3.mlp.down_proj",
        "model.layers.0.mlp.up_proj",
    ],
)
def test_quantization_config_lookup_matches(path):
    got = tcfg.QuantizationConfig.from_dict(_QCFG).lookup(path)
    want = jcfg.QuantizationConfig.from_dict(_QCFG).lookup(path)
    if want is None:
        assert got is None
        return
    assert got.to_dict() == want.to_dict()
    for prop in (
        "padding", "num_indices", "outlier_padding", "outlier_num_indices",
        "index_bits", "res_index_bits", "packed_group_size",
        "enable_outlier", "enable_residual", "equivalent_bits",
    ):
        assert getattr(got, prop) == getattr(want, prop), prop


def test_quantization_config_rejects_other_methods():
    with pytest.raises(ValueError):
        tcfg.QuantizationConfig.from_dict({"quant_method": "gptq"})


@pytest.mark.parametrize(
    "index_bits,res_bits,group",
    [
        (16, 0, 37),   # two ids per word, odd tail
        (12, 0, 29),   # straddles every few ids
        (13, 7, 50),   # 20-bit merged ids, residual
        (10, 8, 33),
        (16, 16, 9),   # full 32-bit merged ids
        (3, 0, 100),
        (8, 0, 16),
        (12, 4, 64),
        (11, 5, 1),
    ],
)
def test_pack_unpack_exact(index_bits, res_bits, group):
    rng = np.random.default_rng(index_bits * 100 + res_bits + group)
    main = rng.integers(0, 1 << index_bits, size=(2, 3, group))
    res = rng.integers(0, 1 << res_bits, size=(2, 3, group)) if res_bits else None

    want = jpack.pack_index(main, index_bits, res, res_bits)
    got = tpack.pack_index(
        torch.from_numpy(main), index_bits,
        None if res is None else torch.from_numpy(res), res_bits,
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)

    j_main, j_res = jpack.unpack_index(want, index_bits, group, res_bits)
    t_main, t_res = tpack.unpack_index(
        torch.from_numpy(want), index_bits, group, res_bits
    )
    np.testing.assert_array_equal(t_main.numpy(), j_main)
    np.testing.assert_array_equal(t_main.numpy(), main)
    if res_bits:
        np.testing.assert_array_equal(t_res.numpy(), j_res)
        np.testing.assert_array_equal(t_res.numpy(), res)
    else:
        assert t_res is None and j_res is None


@pytest.mark.parametrize("dtype", [np.int16, np.float16, np.int32, np.int64])
def test_view_as_uint16_matches(dtype):
    rng = np.random.default_rng(3)
    u16 = rng.integers(0, 1 << 16, size=64).astype(np.uint16)
    stored = u16.view(dtype) if np.dtype(dtype).itemsize == 2 else u16.astype(dtype)
    want = jpack.view_as_uint16(stored)
    got = tpack.view_as_uint16(torch.from_numpy(stored))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("num_centroids", [256, 65536])
def test_index_planes_roundtrip(num_centroids):
    rng = np.random.default_rng(num_centroids)
    ids = rng.integers(0, num_centroids, size=(3, 40))
    plane = tpack.to_index_plane(torch.from_numpy(ids), num_centroids)
    assert plane.element_size() == jpack.index_plane_dtype(num_centroids).itemsize
    np.testing.assert_array_equal(tpack.widen_index(plane).numpy(), ids)
