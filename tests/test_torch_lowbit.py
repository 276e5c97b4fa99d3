"""vptq_tpu_torch int4 / int3 / int2 formats against vptq_tpu.

* Quantizers, packers and encoders must give the JAX package's numpy
  bytes exactly (its optional C++ host library is switched off),
  including all-zero groups, half-way quotients and near-tie groups whose
  scale choice hangs on the last bit of the error sum.
* The plain versions of K2, K3 and K4 must agree with the Pallas kernels
  run in interpret mode.
"""

import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_port import port_layer

from vptq_tpu import native
from vptq_tpu.layers import runtime as jrt
from vptq_tpu.ops import packing as jp
from vptq_tpu.ops import pallas_gemm
from vptq_tpu.utils.synth import make_config, make_numpy_planes, planes_to_layer
from vptq_tpu_torch.layers import runtime as trt
from vptq_tpu_torch.ops import packing as tp
from vptq_tpu_torch.ops.w2_matmul import w2_matmul, w2_matmul_reference
from vptq_tpu_torch.ops.w3_matmul import w3_matmul, w3_matmul_reference
from vptq_tpu_torch.ops.w4_matmul import w4_matmul, w4_matmul_reference

FORMATS = ("int4", "int3", "int2")
# quantizer: (divisor, shrink factors, code range, level offset, group)
SPEC = {
    "int4": (7.0, jp.INT4_SCALE_CANDIDATES, -7, 7, 0.0, 128),
    "int3": (3.5, jp.INT4_SCALE_CANDIDATES + (1.15, 1.3), -4, 3, 0.0, 128),
    "int2": (1.5, jp.INT2_SCALE_CANDIDATES, -2, 1, 0.5, 64),
}


@pytest.fixture
def numpy_encoder(monkeypatch):
    """The JAX package's numpy encoders (the C++ host library, when it
    builds, takes over _encode_int4 and _encode_int2)."""
    monkeypatch.setattr(native, "_lib", lambda: None)


def _quantize(fmt):
    return getattr(jp, f"quantize_{fmt}"), getattr(tp, f"quantize_{fmt}")


def _weight(out_f, in_f, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((out_f, in_f)).astype(np.float32)
    w[0, :] = 0.0  # all-zero groups take scale 1
    # groups whose first scale is 1 and whose quotients fall half-way:
    # absmax 7 (int4), 3.5 (int3) and 1.5 (int2), then x.5 values and, for
    # the int2 offset, integers (g / s - 0.5 half-way)
    w[1, :128] = 0.25
    w[1, :8] = [7.0, 3.5, 2.5, -0.5, -1.5, 0.5, 5.5, -6.5]
    w[2, :128] = 0.5
    w[2, :6] = [3.5, 2.5, -2.5, 1.5, -0.5, -3.5]
    w[3, :64] = 1.0
    w[3, :6] = [1.5, 1.0, -1.0, 0.0, -1.5, 0.5]
    return w


def _bits(a):
    """Bit pattern of f32 / bf16 arrays and tensors."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a.view(torch.int32)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a.view(np.int32)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape", [(16, 1024), (40, 2048), (8, 3072)])
def test_quantize_and_pack_byte_equal(fmt, shape):
    w = _weight(*shape, seed=shape[0] + shape[1])
    jq, tq = _quantize(fmt)
    want_q, want_s = jq(w)
    got_q, got_s = tq(torch.from_numpy(w))
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(_bits(got_s), _bits(want_s))
    q = torch.from_numpy(want_q)
    if fmt == "int3":
        want = jp.pack_int3(want_q)
        got = tp.pack_int3(q)
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), wnt)
        np.testing.assert_array_equal(tp.unpack_int3(*got).numpy(), want_q)
    else:
        want = getattr(jp, f"pack_{fmt}")(want_q)
        got = getattr(tp, f"pack_{fmt}")(q)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            getattr(tp, f"unpack_{fmt}")(got).numpy(),
            getattr(jp, f"unpack_{fmt}")(want),
        )


def _bf16(x):
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


def _candidates(g, fmt):
    """(scale, codes, f32 squared errors) of every candidate, as the
    numpy quantizer computes them."""
    div, factors, lo, hi, off, _ = SPEC[fmt]
    base = np.float32(np.abs(g).max() / np.float32(div))
    out = []
    for f in factors:
        s = _bf16(np.float32(base * np.float32(f)))
        q = np.clip(np.round(g / s - np.float32(off)) if off else np.round(g / s), lo, hi)
        d = g - (q + np.float32(off)) * s if off else g - q * s
        out.append((s, q, d * d))
    return out


def _near_tie_groups(fmt, n, seed):
    """Groups whose two best candidates have equal error sums to within
    the last bits of an f32 sum: one element (not the absmax) of a random
    group is moved, inside its quantization cells, by the amount that
    equalizes the two exact (float64) sums of the f32 squared errors."""
    rng = np.random.default_rng(seed)
    size, off = SPEC[fmt][5], SPEC[fmt][4]
    groups = []
    while len(groups) < n:
        g = rng.standard_normal(size).astype(np.float32)
        c = _candidates(g, fmt)
        exact = np.array([e.astype(np.float64).sum() for _, _, e in c])
        a, b = np.argsort(exact)[:2]
        ra = g - (c[a][1] + off) * c[a][0]
        rb = g - (c[b][1] + off) * c[b][0]
        i = np.argmax(np.abs(ra - rb) * (np.abs(g) < np.abs(g).max()))
        t = -(exact[a] - exact[b]) / (2.0 * (float(ra[i]) - float(rb[i])))
        if abs(t) > 0.05 * min(c[a][0], c[b][0]):
            continue
        g2 = g.copy()
        g2[i] = np.float32(g[i] + t)
        c2 = _candidates(g2, fmt)
        if np.array_equal(c2[a][1], c[a][1]) and np.array_equal(c2[b][1], c[b][1]):
            groups.append(g2)
    return np.stack(groups).reshape(-1, 1024)


@pytest.mark.parametrize("fmt", FORMATS)
def test_near_tie_groups_follow_numpy_sum_order(fmt, monkeypatch):
    w = _near_tie_groups(fmt, 128, seed=FORMATS.index(fmt))
    jq, tq = _quantize(fmt)
    want_q, want_s = jq(w)
    got_q, got_s = tq(torch.from_numpy(w))
    np.testing.assert_array_equal(_bits(got_s), _bits(want_s))
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    # the groups really are near-ties: torch.sum's order picks another
    # scale in some of them
    monkeypatch.setattr(
        tp, "_group_sq_err", lambda g, lv, s: ((g - lv * s[..., None]) ** 2).sum(-1)
    )
    _, naive_s = tq(torch.from_numpy(w))
    assert (naive_s.numpy() != want_s).sum() > 0


def test_group_sq_err_is_numpy_sum():
    rng = np.random.default_rng(5)
    for n in (64, 128):
        g = rng.standard_normal((500, 4, n)).astype(np.float32)
        lv = np.round(g * 3).astype(np.float32)
        s = (rng.random((500, 4)) * 0.3 + 0.2).astype(np.float32)
        want = ((g - lv * s[:, :, None]) ** 2).sum(axis=-1)
        got = tp._group_sq_err(*map(torch.from_numpy, (g, lv, s)))
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _encode(mod, fmt, w, **kw):
    return getattr(mod, f"_encode_{fmt}")(w, None, **kw)


def _assert_same_layer(got, want):
    names = ("wq2", "wq1", "scales") if hasattr(want, "wq2") else ("wq", "scales")
    for name in names:
        g, wnt = getattr(got, name), getattr(want, name)
        assert tuple(g.shape) == np.asarray(wnt).shape, name
        np.testing.assert_array_equal(_bits(g) if name == "scales" else g.numpy(),
                                      _bits(wnt) if name == "scales" else np.asarray(wnt),
                                      err_msg=name)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("in_f", [1000, 3000, 4096])
def test_encode_byte_equal(numpy_encoder, fmt, in_f):
    w = _weight(24, in_f, in_f)
    _assert_same_layer(
        _encode(trt, fmt, torch.from_numpy(w)), _encode(jrt, fmt, w)
    )


def test_encode_int2_group_128(numpy_encoder):
    w = _weight(16, 2048, 3)
    got = _encode(trt, "int2", torch.from_numpy(w), group=128)
    _assert_same_layer(got, _encode(jrt, "int2", w, group=128))
    assert got.group == 128


@pytest.mark.parametrize("fmt", FORMATS)
def test_blocked_encodings_raise(fmt):
    with pytest.raises(NotImplementedError, match="shards"):
        _encode(trt, fmt, torch.zeros(8, 2048), shards=2)


@pytest.mark.parametrize("fmt", FORMATS)
def test_to_format_from_vq_layer_byte_equal(numpy_encoder, fmt):
    """bf16 planes (the loader's cast) → exact f32 dequant → re-encode."""
    cfg = make_config(
        in_features=640, out_features=192, vector_len=8, num_centroids=1024,
        num_res_centroids=64, enable_norm=True, enable_perm=True,
    )
    planes = make_numpy_planes(cfg, seed=11)
    jlayer = planes_to_layer(planes, cfg, dtype=jnp.bfloat16)
    tlayer = port_layer(planes, cfg)
    for name in ("centroids", "res_centroids", "weight_scale", "weight_bias"):
        setattr(tlayer, name, getattr(tlayer, name).to(torch.bfloat16))
    want = jrt.to_runtime(jlayer, fmt)
    got = trt.to_runtime(tlayer, fmt)
    assert type(got).__name__ == type(want).__name__
    _assert_same_layer(got, want)
    # exact dequant of the runtime layout, padding dropped
    np.testing.assert_array_equal(
        trt.linear_exact_weight(got, 640).numpy(),
        jrt.linear_exact_weight(want, 640),
    )


@pytest.mark.parametrize("fmt", FORMATS)
def test_fuse_linears_matches(numpy_encoder, fmt):
    ws = [_weight(n, 1024, n) for n in (32, 8, 8)]
    want = jrt.fuse_linears([_encode(jrt, fmt, w) for w in ws])
    parts = [_encode(trt, fmt, torch.from_numpy(w)) for w in ws]
    got = trt.fuse_linears(parts)
    assert type(got) is type(parts[0])
    _assert_same_layer(got, want)
    assert trt.fuse_linears([got, trt._encode_int8(torch.zeros(4, 1024), None)]) is None
    # another padded in_features is not fused
    assert trt.fuse_linears([got, _encode(trt, fmt, torch.zeros(4, 3000))]) is None


def test_dense_to_int4_byte_equal(numpy_encoder):
    from vptq_tpu.layers.dense import DenseLinear as JDense
    from vptq_tpu_torch.layers.dense import DenseLinear as TDense

    w = _weight(16, 1000, 4)
    bias = np.linspace(-1, 1, 16).astype(np.float32)
    got = trt.dense_to_int4(TDense(torch.from_numpy(w), torch.from_numpy(bias)))
    want = jrt.dense_to_int4(JDense(jnp.asarray(w), jnp.asarray(bias)))
    _assert_same_layer(got, want)
    np.testing.assert_array_equal(got.bias.numpy(), np.asarray(want.bias))


def _pallas(monkeypatch, fn, *arrays, **kw):
    monkeypatch.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
    return np.asarray(fn(*map(jnp.asarray, arrays), out_dtype=jnp.float32, **kw))


def _case(kernel, rng, tokens, out_f=200, in_p=2048):
    """Random packed weights, scales and x for one kernel."""
    def codes(n):
        return rng.integers(-128, 128, size=(out_f, n)).astype(np.int8)

    def scales(shape):
        return _bf16((0.01 * (1 + rng.random(shape))).astype(np.float32)).astype(
            ml_dtypes.bfloat16
        )

    x = rng.standard_normal((tokens, in_p)).astype(np.float32)
    if kernel == "w4":
        return x, (codes(in_p // 2), scales((in_p // 128, out_f)))
    if kernel == "w3":
        return x, (codes(in_p // 4), codes(in_p // 8), scales((out_f, in_p // 128)))
    group = int(kernel[len("w2g"):])
    return x, (codes(in_p // 4), scales((out_f, in_p // group)))


KERNELS = {
    "w4": (w4_matmul, w4_matmul_reference, pallas_gemm.w4_matmul,
           dict(out_tile=256, in_tile=1024)),
    "w3": (w3_matmul, w3_matmul_reference, pallas_gemm.w3_matmul,
           dict(out_tile=256, in_tile=1024)),
    "w2g64": (w2_matmul, w2_matmul_reference, pallas_gemm.w2_matmul,
              dict(out_tile=256, in_tile=1024)),
    "w2g128": (w2_matmul, w2_matmul_reference, pallas_gemm.w2_matmul,
               dict(out_tile=256, in_tile=1024)),
}


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("tokens", [1, 3, 17, 40])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_reference_matches_pallas(monkeypatch, kernel, tokens):
    rng = np.random.default_rng(tokens * 13 + len(kernel))
    x, weights = _case(kernel, rng, tokens)
    fn, ref, pallas, tiles = KERNELS[kernel]
    want = _pallas(monkeypatch, pallas, x, *weights, **tiles)
    before = fn.launches
    args = (_torch(x), *map(_torch, weights))
    got = fn(*args, out_dtype=torch.float32).numpy()
    assert fn.launches == before  # CPU tensors take the plain path
    np.testing.assert_array_equal(got, ref(*args, out_dtype=torch.float32).numpy())
    # both sum exact products of bf16-rounded x and exact levels in f32
    # and scale each group's f32 partial; only the summation order (and
    # K3's x-group-sum form of the +0.5) differ, so errors stay at f32
    # rounding of the largest terms
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert got.shape == (tokens, 200)


@pytest.mark.parametrize("fmt", FORMATS)
def test_layer_pads_activations(numpy_encoder, monkeypatch, fmt):
    """in_features 1000 → padded; zeros contribute nothing; bias added."""
    w = _weight(24, 1000, 1)
    bias = np.linspace(-1, 1, 24).astype(np.float32)
    tlayer = getattr(trt, f"_encode_{fmt}")(torch.from_numpy(w), torch.from_numpy(bias))
    jlayer = getattr(jrt, f"_encode_{fmt}")(w, jnp.asarray(bias))
    x = np.random.default_rng(2).standard_normal((2, 3, 1000)).astype(np.float32)
    got = tlayer(torch.from_numpy(x)).numpy()
    monkeypatch.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL", "pallas")
    want = np.asarray(jlayer(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 3, 24)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize(
    "kernel,bad",
    [
        ("w4", lambda wq, s: (wq[:, :-16], s)),  # in_p not a multiple of 256
        ("w4", lambda wq, s: (wq, s.float())),  # f32 scales
        ("w2g64", lambda wq, s: (wq, s[:, :-1])),  # scales do not divide
        ("w2g64", lambda wq, s: (wq, s.repeat(1, 4))),  # group 16
    ],
)
def test_wrappers_reject_bad_arguments(kernel, bad):
    x, weights = _case(kernel, np.random.default_rng(0), 2)
    fn = KERNELS[kernel][0]
    wq, s = bad(*map(_torch, weights))
    with pytest.raises(ValueError):
        fn(torch.zeros(2, wq.shape[1] * (2 if kernel == "w4" else 4)), wq, s)
