"""vptq_tpu_torch int8 runtime against vptq_tpu.

The int8 encoding (``wq`` and ``scales``) must be byte-equal to the JAX
package's numpy encoder, and the plain version of K1 must agree with
the Pallas ``w8_matmul`` run in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptq_tpu import native
from vptq_tpu.layers import runtime as jrt
from vptq_tpu.ops.pallas_gemm import w8_matmul as j_w8_matmul
from vptq_tpu.utils.synth import make_config, make_numpy_planes, planes_to_layer
from vptq_tpu_torch.layers import runtime as trt
from vptq_tpu_torch.layers.dense import DenseLinear
from vptq_tpu_torch.ops.w8_matmul import w8_matmul, w8_matmul_reference
from torch_port import port_layer


@pytest.fixture
def numpy_encoder(monkeypatch):
    """The JAX package's numpy encoder: its optional C++ host library
    multiplies by 1/scale where the numpy path divides."""
    monkeypatch.setattr(native, "_lib", lambda: None)


def _weight(out_f, in_f, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((out_f, in_f)).astype(np.float32)
    w[0, :] = 0.0  # all-zero groups take scale 1
    # exact half-way quotients: round-half-to-even must agree
    w[1, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0])
    return w


@pytest.mark.parametrize(
    "out_f,in_f,group",
    [(24, 512, 512), (16, 1024, None), (8, 1000, 512), (40, 2048, 1024),
     (8, 4096, None), (12, 3000, None)],
)
def test_encode_int8_byte_equal(numpy_encoder, out_f, in_f, group):
    w = _weight(out_f, in_f, in_f + out_f)
    want = jrt._encode_int8(w, None, group)
    got = trt._encode_int8(torch.from_numpy(w), None, group)
    assert got.group == want.group
    np.testing.assert_array_equal(got.wq.numpy(), np.asarray(want.wq))
    assert got.scales.dtype == torch.float32
    np.testing.assert_array_equal(
        got.scales.numpy().view(np.uint32), np.asarray(want.scales).view(np.uint32)
    )


@pytest.mark.parametrize("perm", [False, True])
def test_to_int8_from_vq_layer_byte_equal(numpy_encoder, perm):
    """bf16 planes (the loader's cast) → exact f32 dequant → int8."""
    cfg = make_config(
        in_features=640, out_features=192, vector_len=8, num_centroids=1024,
        num_res_centroids=64, enable_norm=True, enable_perm=perm,
    )
    planes = make_numpy_planes(cfg, seed=9)
    jlayer = planes_to_layer(planes, cfg, dtype=jnp.bfloat16)
    tlayer = port_layer(planes, cfg)
    for name in ("centroids", "res_centroids", "weight_scale", "weight_bias"):
        setattr(tlayer, name, getattr(tlayer, name).to(torch.bfloat16))
    np.testing.assert_array_equal(
        trt._exact_weight(tlayer).numpy(), jrt._exact_weight(jlayer)
    )
    want, got = jrt.to_int8(jlayer), trt.to_int8(tlayer)
    np.testing.assert_array_equal(got.wq.numpy(), np.asarray(want.wq))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))


def test_fuse_linears_matches(numpy_encoder):
    ws = [_weight(n, 1024, n) for n in (32, 8, 8)]
    want = jrt.fuse_linears([jrt._encode_int8(w, None) for w in ws])
    got = trt.fuse_linears(
        [trt._encode_int8(torch.from_numpy(w), None) for w in ws]
    )
    assert got.wq.shape == want.wq.shape and got.scales.shape == want.scales.shape
    np.testing.assert_array_equal(got.wq.numpy(), np.asarray(want.wq))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    dense = trt.fuse_linears([DenseLinear(torch.from_numpy(w)) for w in ws])
    assert dense.weight.shape == (48, 1024)
    # mixed types are not fused
    assert trt.fuse_linears([got, dense]) is None


def _pallas_w8(x, wq, scales, group, out_dtype=jnp.float32):
    import os

    os.environ["VPTQ_TPU_PALLAS_INTERPRET"] = "1"
    try:
        return np.asarray(j_w8_matmul(
            jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scales),
            out_tile=128, in_tile=group, out_dtype=out_dtype,
        ))
    finally:
        os.environ["VPTQ_TPU_PALLAS_INTERPRET"] = "0"


@pytest.mark.parametrize("tokens", [1, 3, 17, 40])
@pytest.mark.parametrize("group", [512, 1024, 2048])
def test_w8_matmul_reference_matches_pallas(tokens, group):
    rng = np.random.default_rng(tokens * 7 + group)
    out_f, in_p = 200, 2 * group  # 200 is not a multiple of the tile
    wq = rng.integers(-127, 128, size=(out_f, in_p)).astype(np.int8)
    scales = (0.01 * (1 + rng.random((in_p // group, out_f)))).astype(np.float32)
    x = rng.standard_normal((tokens, in_p)).astype(np.float32)

    want = _pallas_w8(x, wq, scales, group)
    before = w8_matmul.launches
    got = w8_matmul(
        torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(scales)
    ).numpy()
    assert w8_matmul.launches == before  # CPU tensors take the plain path
    np.testing.assert_array_equal(
        got,
        w8_matmul_reference(
            torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(scales)
        ).numpy(),
    )
    # both round x to bf16 and sum exact products in f32 per group; only
    # the summation order differs (tighter than test_runtime.py's
    # rtol 2e-2, atol 5e-3*max|y|)
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max()
    )


def test_int8_linear_pads_activations():
    """in_features 1000 → padded to 1024; zeros contribute nothing."""
    w = _weight(24, 1000, 1)
    layer = trt._encode_int8(torch.from_numpy(w), torch.ones(24))
    assert layer.wq.shape == (24, 1024)
    x = np.random.default_rng(2).standard_normal((2, 1000)).astype(np.float32)
    got = layer(torch.from_numpy(x)).numpy()
    want = _pallas_w8(
        np.pad(x, ((0, 0), (0, 24))), layer.wq.numpy(), layer.scales.numpy(),
        layer.group,
    ) + 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_pick_group_matches():
    for n in (512, 1000, 2048, 3000, 4096, 11008, 14336, 640):
        assert trt.pick_group(n) == jrt.pick_group(n)
