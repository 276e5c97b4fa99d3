"""The blocked encodings of tensor parallelism against vptq_tpu's.

``layers/runtime.py`` ``_encode_int{8,4,3,2}(..., shards=n)`` and
``to_runtime(..., row_shards=n)`` must give the JAX package's numpy bytes:
the in axis zero-padded to a multiple of ``n``, each contiguous column
block encoded alone (int8 with its own ``pick_group``; int4 blocks padded
to 512 columns, 256 below 512; int3 and int2 blocks to 1024), the blocks'
codes and scales concatenated on the JAX package's axes. Widths cover a
block count that does not divide them, every pad, and blocks wide enough
to need none. The JAX package's C++ host encoders are switched off, as in
the other byte tests.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_port import port_layer

from vptq_tpu import native
from vptq_tpu.layers import runtime as jrt
from vptq_tpu.utils.synth import make_config, make_numpy_planes, planes_to_layer
from vptq_tpu_torch.layers import runtime as trt
from vptq_tpu_torch.parallel import tp
from vptq_tpu_torch.parallel.mesh import Mesh

FORMATS = ("int8", "int4", "int3", "int2")
# the buffers of each layer type
ARRAYS = {
    "Int8Linear": ("wq", "scales"), "Int4Linear": ("wq", "scales"),
    "Int3Linear": ("wq2", "wq1", "scales"), "Int2Linear": ("wq", "scales"),
}


@pytest.fixture
def numpy_encoder(monkeypatch):
    monkeypatch.setattr(native, "_lib", lambda: None)


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


def _same(got, want):
    assert type(got).__name__ == type(want).__name__
    for name in ARRAYS[type(got).__name__]:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(g.shape) == w.shape, name
        assert str(g.dtype).removeprefix("torch.") == (
            "bfloat16" if w.dtype == ml_dtypes.bfloat16 else str(w.dtype)), name
        np.testing.assert_array_equal(_bytes(g), _bytes(w), err_msg=name)


def _weight(out_f, in_f, seed):
    rng = np.random.default_rng(seed)
    w = (0.05 * rng.standard_normal((out_f, in_f))).astype(np.float32)
    w[0, : in_f // 3] = 0.0  # all-zero groups
    return w


# 130: blocks of 65 / 33 (4 does not divide 130), int4 pads to 256; 1100:
# blocks of 550 (int4 512-pad) / 275 (256-pad); 2048: blocks of 1024 / 512
# that int4 leaves unpadded; 7232: blocks of 3616 / 1808, int8 groups of
# 1024 / 512 and int3 / int2 pads to 1024
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("in_f", [130, 1100, 2048, 7232])
def test_blocked_encoding_byte_equal(numpy_encoder, fmt, shards, in_f):
    w = _weight(24, in_f, in_f + shards)
    want = getattr(jrt, f"_encode_{fmt}")(w, None, shards=shards)
    got = getattr(trt, f"_encode_{fmt}")(torch.from_numpy(w), None,
                                         shards=shards)
    _same(got, want)
    # each rank's block (parallel/tp.py) is the standard layer its columns
    # encode to alone (int4 packs nibbles within a block: the blocked
    # layer is only read block by block)
    blk = -(-in_f // shards)
    for s in range(shards):
        part = w[:, s * blk: (s + 1) * blk]
        part = np.pad(part, ((0, 0), (0, blk - part.shape[1])))
        alone = getattr(trt, f"_encode_{fmt}")(
            torch.from_numpy(part), None,
            **({"pad_to": 512 if blk >= 512 else 256} if fmt == "int4"
               else {"pad_to": 1024} if fmt == "int3" else {}))
        mesh = Mesh(data=1, model=shards, rank=s)
        _same_torch(tp._in_slice(got, mesh), alone)


def _same_torch(got, want):
    for name in ARRAYS[type(got).__name__]:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("shards", [2, 4])
def test_blocked_int2_group_128(numpy_encoder, shards):
    w = _weight(16, 3000, 9)
    want = jrt._encode_int2(w, None, shards=shards, group=128)
    got = trt._encode_int2(torch.from_numpy(w), None, shards=shards,
                           group=128)
    _same(got, want)
    assert got.group == 128


def test_blocked_int8_keeps_the_bias(numpy_encoder):
    w = _weight(8, 1100, 2)
    bias = np.arange(8, dtype=np.float32)
    got = trt._encode_int8(torch.from_numpy(w), torch.from_numpy(bias),
                           shards=2)
    _same(got, jrt._encode_int8(w, bias, shards=2))
    np.testing.assert_array_equal(got.bias.numpy(), bias)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("row_shards", [2, 4])
def test_to_runtime_row_shards_from_vq_layer(numpy_encoder, fmt, row_shards):
    """bf16 planes (the loader's cast) → exact f32 dequant → blocked
    re-encode, as the loader encodes a row-parallel layer."""
    cfg = make_config(
        in_features=640, out_features=96, vector_len=8, num_centroids=1024,
        num_res_centroids=64, enable_norm=True, enable_perm=True,
    )
    planes = make_numpy_planes(cfg, seed=13)
    jlayer = planes_to_layer(planes, cfg, dtype=jnp.bfloat16)
    tlayer = port_layer(planes, cfg)
    for name in ("centroids", "res_centroids", "weight_scale", "weight_bias"):
        setattr(tlayer, name, getattr(tlayer, name).to(torch.bfloat16))
    _same(trt.to_runtime(tlayer, fmt, row_shards=row_shards),
          jrt.to_runtime(jlayer, fmt, row_shards=row_shards))


def test_to_runtime_row_shards_keeps_bf16_whole_and_refuses_codebook():
    cfg = make_config(in_features=64, out_features=32, vector_len=8,
                      num_centroids=256)
    tlayer = port_layer(make_numpy_planes(cfg, seed=1), cfg)
    dense = trt.to_runtime(tlayer, "bf16", row_shards=2)
    assert tuple(dense.weight.shape) == (32, 64)
    with pytest.raises(NotImplementedError, match="codebook"):
        trt.to_runtime(tlayer, "codebook", row_shards=2)
    assert trt.to_runtime(tlayer, "codebook") is tlayer
