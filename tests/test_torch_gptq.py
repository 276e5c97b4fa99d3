"""vptq_tpu_torch's GPTQ encoder (``quant/gptq.py``) against vptq_tpu's.

* Without a Hessian and with the identity, codes and scales are the JAX
  package's byte for byte at bits 2, 3, 4 and 8 (and, without a Hessian,
  the port's own RTN encoders' at bits 2, 3 and 4).
* With a correlated Hessian (``tests/test_gptq.py``'s inputs) the factor
  and the f32 products round in another order than LAPACK's and numpy's
  BLAS (and MKL's order follows the thread count), so a few codes move,
  and a moved code feeds another error to the later columns of its row,
  where a neighbour may then move two levels. Stated bounds: at bits 2,
  3 and 4 at most 0.5% of the codes differ from JAX's, by at most two
  levels; at bits 8, whose f32 scales follow the last bits of the updated
  weights, at most 2%, by at most 3 levels. The output error ratio stays
  within 1% of JAX's and well below RTN's.
* ``output_error_ratio`` on the same inputs within 1e-9 relative; the
  flipped-UL factor within 1e-3 of JAX's; the damping ladder on an
  indefinite Hessian, a Hessian that no damping saves, dead columns;
  numpy's pairwise sum order; ``true_f32`` gives the caller's TF32
  setting back.
"""

import numpy as np
import pytest
import torch
import torch_port  # noqa: F401  (one torch thread: MKL's order follows it)

from vptq_tpu.quant import gptq as jg
from vptq_tpu_torch.ops import packing as tp
from vptq_tpu_torch.quant import gptq as tg

# (bits, group) of each format's encode: int2 64, int3 / int4 128, int8 a
# group that is no scale-search group of the others
FORMATS = [(2, 64), (3, 128), (4, 128), (8, 256)]
# (share of codes that may differ from JAX's, levels they may differ by)
# under a correlated Hessian
CORRELATED_BOUND = {2: (5e-3, 2), 3: (5e-3, 2), 4: (5e-3, 2), 8: (2e-2, 3)}


def _correlated_inputs(in_f, n, rank_frac=4, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, in_f // rank_frac)).astype(np.float32)
    proj = rng.standard_normal((in_f // rank_frac, in_f)).astype(
        np.float32
    )
    return z @ proj + 0.1 * rng.standard_normal((n, in_f)).astype(
        np.float32
    )


def _weight(out_f, in_f, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((out_f, in_f)) * 0.02).astype(np.float32)


def _port(w, h, **kw):
    q, s = tg.gptq_quantize(
        torch.from_numpy(w), None if h is None else torch.from_numpy(h), **kw
    )
    return q.numpy(), s.numpy()


@pytest.mark.parametrize("in_f,group,block", [
    (512, 128, None), (640, 128, 320), (200, 64, None), (4096, 2048, None),
])
def test_group_spans_match_jax(in_f, group, block):
    assert tg.group_spans(in_f, group, block) == jg.group_spans(
        in_f, group, block)


@pytest.mark.parametrize("hess", ["none", "identity"])
@pytest.mark.parametrize("bits,group", FORMATS)
def test_codes_without_feedback_equal_jax(bits, group, hess):
    w = _weight(96, 512, seed=bits)
    # positive-absmax groups: the int3 growth candidates decide there
    w[:, ::7] = np.abs(w[:, ::7]) * 3.0
    h = None if hess == "none" else np.eye(512)
    qj, sj = jg.gptq_quantize(w, h, bits=bits, group=group)
    qt, st = _port(w, h, bits=bits, group=group)
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(st, sj)
    if hess == "none" and bits != 8:
        # the RTN encoders' grid, byte for byte
        rtn = {2: tp.quantize_int2, 3: tp.quantize_int3,
               4: tp.quantize_int4}[bits]
        q_rtn, s_rtn = rtn(torch.from_numpy(w))
        np.testing.assert_array_equal(qt, q_rtn.numpy())
        np.testing.assert_array_equal(st, s_rtn.numpy())


def test_codes_without_feedback_at_a_short_last_group():
    # 200 columns at group 128: one whole group and one of 72
    w = _weight(40, 200, seed=9)
    for bits in (2, 4, 8):
        qj, sj = jg.gptq_quantize(w, None, bits=bits, group=128)
        qt, st = _port(w, None, bits=bits, group=128)
        np.testing.assert_array_equal(qt, qj)
        np.testing.assert_array_equal(st, sj)


@pytest.mark.parametrize("bits,group", FORMATS)
def test_correlated_hessian_within_the_stated_share(bits, group):
    in_f = 512
    x = _correlated_inputs(in_f, 2048, seed=bits)
    h = (x.T @ x).astype(np.float64)
    w = _weight(128, in_f, seed=1)
    qj, sj = jg.gptq_quantize(w, h, bits=bits, group=group)
    qt, st = _port(w, h, bits=bits, group=group)
    share, levels = CORRELATED_BOUND[bits]
    diff = np.abs(qt.astype(np.int16) - qj.astype(np.int16))
    assert (diff > 0).mean() <= share, (diff > 0).mean()
    assert diff.max() <= levels
    qmin, qmax = {2: (-2, 1), 3: (-4, 3), 4: (-7, 7), 8: (-127, 127)}[bits]
    assert qt.min() >= qmin and qt.max() <= qmax

    spans = jg.group_spans(in_f, group)
    offset = 0.5 if bits == 2 else 0.0
    e_jax = jg.output_error_ratio(
        w, jg.dequant_groups(qj, sj, spans, offset), h)
    e_port = tg.output_error_ratio(
        torch.from_numpy(w),
        tg.dequant_groups(torch.from_numpy(qt), torch.from_numpy(st), spans,
                          offset),
        torch.from_numpy(h),
    )
    assert abs(e_port - e_jax) <= 1e-2 * e_jax, (e_port, e_jax)
    # error feedback against RTN under the same H (tests/test_gptq.py)
    q0, s0 = _port(w, None, bits=bits, group=group)
    e_rtn = tg.output_error_ratio(
        torch.from_numpy(w),
        tg.dequant_groups(torch.from_numpy(q0), torch.from_numpy(s0), spans,
                          offset),
        torch.from_numpy(h),
    )
    assert e_port < e_rtn / 3.0, (e_port, e_rtn)


@pytest.mark.parametrize("hess", ["none", "correlated"])
def test_output_error_ratio_matches_jax(hess):
    w = _weight(64, 256, seed=3)
    w_hat = w + _weight(64, 256, seed=4) * 0.05
    h = None
    if hess == "correlated":
        x = _correlated_inputs(256, 1024, seed=2)
        h = (x.T @ x).astype(np.float32)
    want = jg.output_error_ratio(w, w_hat, h)
    got = tg.output_error_ratio(
        torch.from_numpy(w), torch.from_numpy(w_hat),
        None if h is None else torch.from_numpy(h),
    )
    assert abs(got - want) <= 1e-9 * want


def test_factor_matches_jax():
    x = _correlated_inputs(256, 1024, seed=6)
    h = (x.T @ x).astype(np.float32)
    want = jg._cholesky_inv_upper(h, 0.01)
    got = tg._cholesky_inv_upper(torch.from_numpy(h), 0.01).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-3 * np.abs(want).max())
    # upper triangular, and H^-1 = U^T U up to the damping
    assert np.all(np.tril(got, -1) == 0)


def _indefinite(n: int, off: float) -> np.ndarray:
    """Block-diagonal 2x2 blocks [[1, off], [off, 1]]: eigenvalues 1 ± off,
    the mean diagonal 1."""
    h = np.eye(n)
    for i in range(0, n, 2):
        h[i, i + 1] = h[i + 1, i] = off
    return h


def test_damping_ladder_on_an_indefinite_hessian(monkeypatch):
    # eigenvalue -0.05: 1x damping (0.01) fails in f32, 10x (0.1) holds
    h = _indefinite(128, 1.05)
    tried = []
    real = tg._cholesky_inv_upper_at

    def spy(hd):
        tried.append((hd.dtype, float(hd[0, 0])))
        return real(hd)

    monkeypatch.setattr(tg, "_cholesky_inv_upper_at", spy)
    w = _weight(32, 128, seed=5)
    qt, st = _port(w, h, bits=4, group=128)
    assert [d for d, _ in tried] == [torch.float32, torch.float32]
    assert tried[1][1] == pytest.approx(1.1)
    qj, sj = jg.gptq_quantize(w, h, bits=4, group=128)
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(st, sj)


def test_hessian_no_damping_saves_raises():
    # eigenvalue -2: even 100x the damping (1.0) leaves it indefinite
    h = _indefinite(64, 3.0)
    w = _weight(16, 64, seed=7)
    with pytest.raises(np.linalg.LinAlgError):
        jg.gptq_quantize(w, h, bits=4, group=64)
    with pytest.raises(np.linalg.LinAlgError):
        _port(w, h, bits=4, group=64)
    h_nan = np.eye(64)
    h_nan[3, 3] = np.nan
    with pytest.raises(np.linalg.LinAlgError):
        _port(w, h_nan, bits=4, group=64)


@pytest.mark.parametrize("bits,group", [(8, 256), (2, 64)])
def test_dead_columns_quantize_to_zero(bits, group):
    out_f, in_f = 64, 512
    x = _correlated_inputs(in_f, 1024, seed=5)
    x[:, 100] = 0.0  # a dead input column
    h = (x.T @ x).astype(np.float64)
    w = _weight(out_f, in_f, seed=2)
    qt, st = _port(w, h, bits=bits, group=group)
    qj, _ = jg.gptq_quantize(w, h, bits=bits, group=group)
    # zeroed before its group's scale: int8 code 0, int2 the level
    # nearest 0 (-0.5 s or 0.5 s), as JAX's
    np.testing.assert_array_equal(qt[:, 100], qj[:, 100])
    if bits == 8:
        assert np.all(qt[:, 100] == 0)
        w_hat = jg.dequant_groups(qt, st, jg.group_spans(in_f, group))
        assert jg.output_error_ratio(w, w_hat, h) < 1e-4


@pytest.mark.parametrize("n", [3, 8, 64, 100, 128, 200, 640, 2048])
def test_pairwise_sum_is_numpys(n):
    rng = np.random.default_rng(n)
    a = (rng.standard_normal((7, n)) ** 2).astype(np.float32)
    got = tg._pairwise_sum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, a.sum(axis=-1))


def test_true_f32_gives_the_setting_back():
    matmul = torch.backends.cuda.matmul
    old = matmul.fp32_precision
    try:
        matmul.fp32_precision = "tf32"
        with tg.true_f32():
            assert matmul.fp32_precision == "ieee"
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = old


@pytest.mark.parametrize("bits,group", [(2, 64), (3, 128), (8, 128)])
def test_kept_steps_give_each_call_its_own_codes(bits, group):
    """Group steps kept across calls (``steps``) give every call the codes
    and scales of a call on its own, also when another shape ran between
    them; one step per shape."""
    w = _weight(64, 384, bits)
    h = _correlated_inputs(384, 1024, seed=bits)
    h = h.T @ h
    want = _port(w, h, bits=bits, group=group)
    other = _weight(32, 256, bits + 1)
    steps = {}
    first = _port(w, h, bits=bits, group=group, steps=steps)
    _port(other, np.eye(256, dtype=np.float32), bits=bits, group=group,
          steps=steps)
    second = _port(w, h, bits=bits, group=group, steps=steps)
    assert len(steps) == 2
    for q, s in (first, second):
        np.testing.assert_array_equal(q, want[0])
        np.testing.assert_array_equal(s, want[1])
