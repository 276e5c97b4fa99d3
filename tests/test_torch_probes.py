"""The int4-unpack probes (P1, P2) and the small-codebook VQ probe (P3)
against the JAX measurement scripts.

Every mode's plain version in ``vptq_tpu_torch.ops`` is held to the
script's Pallas body, run on the CPU in Pallas' TPU interpret mode, on the
same numpy-seeded inputs: ``examples/w4_wall_candidates.py`` ``run_variant``
(P1), ``examples/w4_unpack_ablation.py`` ``variant_matmul`` (P2) and
``examples/vq_smallk_probe.py`` ``vq_matmul`` (P3). Then the port's example
entry points on CPU tensors, and their checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from examples import vq_smallk_probe as jvq
from examples import w4_unpack_ablation as jua
from examples import w4_wall_candidates as jwc
from vptq_tpu_torch.examples import kernel_bench
from vptq_tpu_torch.examples import vq_smallk_probe as tvq
from vptq_tpu_torch.examples import w4_unpack_ablation as tua
from vptq_tpu_torch.examples import w4_wall_candidates as twc
from vptq_tpu_torch.ops.vq_smallk_matmul import vq_smallk_matmul_reference
from vptq_tpu_torch.ops.w4_i32x8_matmul import w4_i32x8_matmul_reference
from vptq_tpu_torch.ops.w4_matmul import w4_matmul_reference
from vptq_tpu_torch.ops.w4_probe_matmul import w4_probe_matmul_reference
from vptq_tpu_torch.ops.w4_raw_probe import w4_raw_probe_reference

OUT, IN, T = 256, 2048, 3
# chip_smoke.py's RTOL and ATOL_FRAC: both sides sum f32 products of the
# same bf16 values and exact levels; they differ in summation order before
# the final bf16 rounding
RTOL, ATOL_FRAC = 1e-2, 1e-3


def _inputs(seed=0, lo=-120, hi=120):
    """x (bf16 values, |x| < 128 for s8dot), raw bytes in [lo, hi), random
    int32 words, bf16 scales: as numpy f32 / int arrays."""
    rng = np.random.default_rng(seed)
    x = np.asarray(
        jnp.asarray(4.0 * rng.standard_normal((T, IN)), jnp.bfloat16),
        np.float32)
    wq8 = rng.integers(lo, hi, (OUT, IN // 2)).astype(np.int8)
    wq32 = rng.integers(-(2 ** 31), 2 ** 31 - 1, (OUT, IN // 8),
                        dtype=np.int64).astype(np.int32)
    scales = np.asarray(
        jnp.asarray(0.005 * (1 + rng.random((IN // 128, OUT))), jnp.bfloat16),
        np.float32)
    return x, wq8, wq32, scales


def _assert_close(got: torch.Tensor, want, rtol=RTOL, atol_frac=ATOL_FRAC):
    want = np.asarray(want, np.float32)
    got = got.to(torch.float32).numpy()
    assert got.shape == want.shape
    err = np.abs(got - want)
    limit = rtol * np.abs(want) + atol_frac * np.abs(want).max()
    assert np.all(err <= limit), (err.max(), np.abs(want).max())


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def test_inputs_hold_the_edge_cases():
    """fma16's ties at x.5 (b = 16·n + 8) and negative i32x8 words are in
    the inputs every case below uses."""
    _, wq8, wq32, _ = _inputs()
    assert np.any(wq8 % 16 == 8) and np.any(wq8 == -120)
    assert np.any(wq32 < 0) and np.any((wq32 >> 28) & 15 >= 8)


# the wall-candidates script's modes -> the port's op and mode
P1 = {
    "prod": ("probe", "shift28"), "fma16": ("probe", "fma16"),
    "fma16f32": ("probe", "fma16f32"), "i32x8": ("i32x8", None),
    "s8dot": ("raw", "s8dot"), "cvtonly": ("raw", "cvtonly"),
}


def _port(op, mode, x, wq, scales):
    if op == "probe":
        return w4_probe_matmul_reference(x, wq, scales, mode)
    if op == "i32x8":
        return w4_i32x8_matmul_reference(x, wq, scales)
    xh = x[:, : x.shape[1] // 2]
    if mode == "s8dot":
        xh = xh.to(torch.int8)  # truncates toward zero, as JAX's astype
    return w4_raw_probe_reference(xh, wq, scales, mode, out_dtype=x.dtype)


@pytest.mark.parametrize("mode", list(P1))
def test_p1_plain_versions_match_wall_candidates(mode):
    x, wq8, wq32, scales = _inputs()
    wq = wq32 if mode == "i32x8" else wq8
    with pltpu.force_tpu_interpret_mode():
        want = jwc.run_variant(
            mode, jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq),
            jnp.asarray(scales, jnp.bfloat16), out_tile=256, in_tile=1024)
    op, port_mode = P1[mode]
    got = _port(op, port_mode, _bf16(x), torch.from_numpy(wq), _bf16(scales))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _assert_close(got, want)


@pytest.mark.parametrize("mode", ["prod", "shift28", "t8", "g256"])
def test_p2_plain_versions_match_unpack_ablation(mode):
    x, wq8, _, scales = _inputs(seed=1, lo=-128, hi=128)
    with pltpu.force_tpu_interpret_mode():
        want = jua.variant_matmul(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq8),
            jnp.asarray(scales), out_tile=256, in_tile=1024, mode=mode)
    got = w4_probe_matmul_reference(
        _bf16(x), torch.from_numpy(wq8), _bf16(scales), mode)
    _assert_close(got, want)


def test_p2_modes_that_share_a_function_agree_bit_for_bit():
    """prod is K2's function; shift28's 2⁻²⁸ fold and the f32 x of t8 and
    fma16f32 change no number."""
    x, wq8, _, scales = _inputs(seed=2, lo=-128, hi=128)
    args = (torch.from_numpy(x), torch.from_numpy(wq8), _bf16(scales))
    prod = w4_probe_matmul_reference(*args, "prod")
    assert torch.equal(prod, w4_matmul_reference(*args))
    for mode in ("shift28", "t8"):
        assert torch.equal(w4_probe_matmul_reference(*args, mode), prod)
    assert torch.equal(w4_probe_matmul_reference(*args, "fma16f32"),
                       w4_probe_matmul_reference(*args, "fma16"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [200, 256])
@pytest.mark.parametrize("onehot_only", [False, True])
@pytest.mark.parametrize("v", [4, 8])
def test_p3_plain_version_matches_vq_smallk_probe(v, onehot_only, k, dtype):
    """Ids drawn from [0, 256): with k = 200 an id >= k must add 0."""
    rng = np.random.default_rng(v + k)
    out_f, in_f = 256, 512
    ids = rng.integers(0, 256, (out_f, in_f // v)).astype(np.uint8)
    cb = rng.normal(0, 0.02, (k, v)).astype(np.float32)
    x = rng.normal(0, 1, (T, in_f)).astype(np.float32)
    assert k == 256 or np.any(ids >= k)
    with pltpu.force_tpu_interpret_mode():
        want = jvq.vq_matmul(
            jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(ids),
            jnp.asarray(cb), v=v, out_tile=256, in_tile=256,
            onehot_only=onehot_only)
    got = vq_smallk_matmul_reference(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(ids),
        torch.from_numpy(cb), v, onehot_only)
    assert str(got.dtype) == f"torch.{dtype}" and want.dtype == dtype
    if dtype == "float32":
        # f32 out: the summation order alone
        _assert_close(got, want, rtol=0.0, atol_frac=1e-5)
    else:
        _assert_close(got, want)


# ------------------------------------------------------------ the examples


def test_kernel_bench_timer_runs_on_the_cpu():
    timeit = kernel_bench.make_timer(2)
    seconds = timeit(lambda v: v * 2.0, torch.ones(8))
    assert seconds > 0.0


@pytest.mark.parametrize("mode", list(P1))
def test_run_variant_is_the_op_on_cpu_tensors(mode):
    x, wq8, wq32, scales = _inputs(seed=3)
    wq = torch.from_numpy(wq32 if mode == "i32x8" else wq8)
    op, port_mode = P1[mode]
    got = twc.run_variant(mode, _bf16(x), wq, _bf16(scales))
    assert torch.equal(got, _port(op, port_mode, _bf16(x), wq, _bf16(scales)))


def test_variant_matmul_casts_scales_and_x_as_the_script():
    x, wq8, _, scales = _inputs(seed=4, lo=-128, hi=128)
    wq = torch.from_numpy(wq8)
    for mode in ("prod", "shift28", "t8", "g256"):
        got = tua.variant_matmul(_bf16(x), wq, torch.from_numpy(scales),
                                 mode=mode)
        want = w4_probe_matmul_reference(_bf16(x), wq, _bf16(scales), mode)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_script_checks_pass_on_the_cpu():
    """check_fma16_exact and the shift28 check: bf16 x and bf16 scales
    against the f32 numpy product (the scripts print these; about 2⁻⁸)."""
    assert twc.check_fma16_exact("cpu") < 2e-2
    assert tua.check_shift28("cpu") < 2e-2
    err, limit = tvq.check("cpu")
    assert err < limit
