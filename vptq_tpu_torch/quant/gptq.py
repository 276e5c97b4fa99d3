"""Error-feedback weight quantization (GPTQ) for the runtime formats.

Port of ``vptq_tpu/quant/gptq.py`` on torch tensors, on the weight's
device. A weight matrix is rounded column by column; after each column
the rounding error, whitened by the Cholesky factor of the inverse input
Hessian ``H = X^T X``, is subtracted from the columns not yet rounded, so
correlated input directions absorb each other's rounding noise (Frantar
et al., 2023), for the group-scaled int8 / int4 / int3 / int2 layouts of
:mod:`vptq_tpu_torch.layers.runtime`.

It runs once, at load, and the serving path is unchanged: the codes feed
the formats' kernels through the ``*_from_q`` constructors.

Arithmetic, against the JAX package's numpy and LAPACK:

  * without a Hessian, or with a diagonal one, the codes and scales are
    theirs bit for bit: the scale search sums each group's squared errors
    in numpy's pairwise order (:func:`_pairwise_sum`), divides as IEEE
    division, and keeps the first candidate of least error, as numpy's
    strictly-lower loop does;
  * with a full Hessian the factor (``torch.linalg``) and the f32 products
    round in another order than LAPACK's and numpy's BLAS, so a few codes
    move by one level;
  * every product runs in true f32 (:func:`true_f32`), whatever TF32
    setting the caller left.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vptq_tpu_torch.ops.packing import (
    INT2_SCALE_CANDIDATES,
    INT4_SCALE_CANDIDATES,
)

__all__ = ["gptq_quantize", "group_spans", "output_error_ratio"]


@contextlib.contextmanager
def true_f32():
    """cuBLAS's f32 products without TF32 inside the block (the caller's
    setting comes back after it). The CPU has no TF32."""
    matmul = torch.backends.cuda.matmul
    old = matmul.fp32_precision
    matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision = old


def group_spans(
    in_features: int, group: int, block: Optional[int] = None
) -> List[Tuple[int, int]]:
    """Scale-group column spans [start, end) for a row of weights.

    ``block``: an outer block width that no group straddles (the last
    group of each block may be short).
    """
    spans = []
    block = block or in_features
    for b0 in range(0, in_features, block):
        b1 = min(b0 + block, in_features)
        for g0 in range(b0, b1, group):
            spans.append((g0, min(g0 + group, b1)))
    return spans


def _bf16_rne(x: torch.Tensor) -> torch.Tensor:
    """Round f32 → nearest-even bf16 → f32."""
    return x.to(torch.bfloat16).to(torch.float32)


# (qmin, qmax, scale-base divisor, level offset) per bit width; int3 is
# the asymmetric range of the plane format, int2 the half-offset grid
# ``(q + 0.5) * s`` of the w2 plane format
_BIT_RANGES = {
    2: (-2, 1, 1.5, 0.5),
    3: (-4, 3, 3.5, 0.0),
    4: (-7, 7, 7.0, 0.0),
    8: (-127, 127, 127.0, 0.0),
}


def _pairwise_sum(e: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in numpy's pairwise order for a contiguous
    float32 axis: below 8 elements one by one; up to 128 in eight lanes
    (lane j takes elements j, j+8, ...) added as ((r0+r1)+(r2+r3)) +
    ((r4+r5)+(r6+r7)), then the rest one by one; above 128 the two halves
    (the first a multiple of 8) summed so and added. Every step is its own
    elementwise op, so nothing is fused into an FMA, on any device."""
    n = e.shape[-1]
    if n < 8:
        res = e[..., 0]
        for i in range(1, n):
            res = res + e[..., i]
        return res
    if n <= 128:
        m = n - n % 8
        r = e[..., :8]
        for i in range(8, m, 8):
            r = r + e[..., i: i + 8]
        res = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + (
            (r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])
        )
        for i in range(m, n):
            res = res + e[..., i]
        return res
    half = n // 2
    half -= half % 8
    return _pairwise_sum(e[..., :half]) + _pairwise_sum(e[..., half:])


def _scale_grid(div: float, candidates: Sequence[float], device):
    """(divisor, factors) of :func:`_group_scale` as f32 tensors on
    ``device``: the base ``absmax / div`` and its shrinks (and growths)."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(div, **f32),
            torch.tensor([1.0, *candidates[1:]], **f32))


def _group_scale(
    w_group: torch.Tensor,
    qmin: int,
    qmax: int,
    div: torch.Tensor,
    bf16_scales: bool,
    factors: torch.Tensor,
    offset: float = 0.0,
    col_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-row scale of one column group (``w_group`` (out, g)).

    The MSE grid search of the RTN encoders: shrinks (and for int3
    growths) of ``absmax / div``, each candidate's round-trip error
    summed over the group, weighted per column by ``col_weights`` (the
    Hessian diagonal, so clipping a high-activation column costs its
    output energy). All candidates are tried at once; the first of least
    error wins, which is what a loop keeping a strictly lower error picks.
    ``div`` and ``factors`` come from :func:`_scale_grid` (a tensor
    divisor: CUDA divides by a host scalar as a multiply by its
    reciprocal, one bit off numpy's division now and then).
    """
    absmax = w_group.abs().amax(dim=-1)
    base = torch.where(absmax > 0, absmax / div, 1.0)
    s = base[None] * factors.reshape(-1, *([1] * base.dim()))
    if bf16_scales:
        s = _bf16_rne(s)
    q = torch.clamp(
        torch.round(w_group[None] / s[..., None] - offset), qmin, qmax
    )
    d = w_group[None] - (q + offset) * s[..., None]
    dw2 = d * d
    if col_weights is not None:
        dw2 = dw2 * col_weights.to(torch.float32)
    err = _pairwise_sum(dw2)
    pick = torch.argmin(err, dim=0, keepdim=True)
    return torch.gather(s, 0, pick)[0]


class _NotFactorizable(Exception):
    pass


def _cholesky_inv_upper_at(h: torch.Tensor) -> torch.Tensor:
    """Upper U with ``H^-1 = U^T U`` via the flipped UL factorization:
    ``L = chol(J H J)``, ``U = J L^-1 J`` (J reverses the order). One
    factor and one triangular inverse, and H^-1 is never formed."""
    low, info = torch.linalg.cholesky_ex(h.flip(0, 1))
    if int(info):
        raise _NotFactorizable("not positive definite")
    eye = torch.eye(h.shape[0], dtype=h.dtype, device=h.device)
    linv = torch.linalg.solve_triangular(low, eye, upper=False)
    del low, eye
    u = linv.flip(0, 1)
    if not bool(torch.isfinite(u).all()):
        raise _NotFactorizable("non-finite factor")
    return u


def _cholesky_inv_upper(h: torch.Tensor, damp: float) -> torch.Tensor:
    """Upper Cholesky factor of H^-1, dampened: f32 first, then 10x the
    damping, then f64 at 1x and at 100x, until it factorizes. The damping
    is ``damp`` times the mean of the diagonal (non-positive entries
    counted as 1), computed on the host in numpy's order."""
    diag = torch.diagonal(h).to(torch.float64)
    safe = torch.where(diag <= 0, 1.0, diag)
    mean_d = float(safe.cpu().numpy().mean())
    for mult, dtype in ((1.0, torch.float32), (10.0, torch.float32),
                        (1.0, torch.float64), (100.0, torch.float64)):
        hd = h.to(dtype, copy=True)
        hd.diagonal().copy_(safe + mult * damp * mean_d)
        try:
            return _cholesky_inv_upper_at(hd)
        except _NotFactorizable:
            continue
        finally:
            del hd
    raise np.linalg.LinAlgError(
        "Hessian not factorizable even with 100x damping"
    )


def _default_candidates(bits: int) -> Tuple[float, ...]:
    if bits == 3:
        # the asymmetric [-4, 3] range needs growths too: a group whose
        # absmax is positive rounds its extreme to 4 and clips at base
        return INT4_SCALE_CANDIDATES + (1.15, 1.3)
    if bits == 2:
        # 2-bit MSE favours clipping: the deep shrink ladder of the RTN
        # encoder
        return INT2_SCALE_CANDIDATES
    return INT4_SCALE_CANDIDATES


def gptq_quantize(
    w: torch.Tensor,  # (out, in) f32: the exact weights
    hessian: Optional[torch.Tensor],  # (in, in): X^T X (f32 / f64)
    *,
    bits: int = 4,
    group: int = 128,
    block: Optional[int] = None,
    damp: float = 0.01,
    scale_candidates: Optional[Sequence[float]] = None,
    steps: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``w`` to group-scaled ints with error feedback, on its
    device.

    Returns ``(q, scales)``: ``q`` int8 of ``w.shape`` in the format's
    range and ``scales`` f32 (out, n_groups), for
    :func:`~vptq_tpu_torch.layers.runtime.int4_from_q` and its siblings.
    ``hessian=None`` is plain RTN with the grid-searched scales. Bits 2,
    3 and 4 store bf16-rounded scales (int3 clips to [-4, 3], int2 uses
    the levels ``(q + 0.5) * s``); bits 8 keeps f32 scales. ``block``:
    groups restart at each multiple of it (:func:`group_spans`).
    ``steps``: a dict the caller keeps across calls, where the error
    feedback leaves its group steps (:class:`_GroupStep`, one recorded
    CUDA graph per shape on the card) for the next call; without it each
    call records its own.
    """
    if bits not in _BIT_RANGES:
        raise ValueError(f"bits must be one of {set(_BIT_RANGES)}")
    qmin, qmax, div, offset = _BIT_RANGES[bits]
    if scale_candidates is None:
        scale_candidates = _default_candidates(bits)
    bf16_scales = bits != 8
    out_f, in_f = w.shape
    spans = group_spans(in_f, group, block)
    if hessian is not None:
        with true_f32():
            return _feedback(w, hessian, spans, qmin, qmax, div, offset,
                             bf16_scales, scale_candidates, damp,
                             {} if steps is None else steps)
    wf = w.to(torch.float32)
    q = torch.zeros((out_f, in_f), dtype=torch.int8, device=w.device)
    scales = torch.zeros(
        (out_f, len(spans)), dtype=torch.float32, device=w.device
    )
    div_t, factors = _scale_grid(div, scale_candidates, w.device)
    for gi, (g0, g1) in enumerate(spans):
        s = _group_scale(wf[:, g0:g1], qmin, qmax, div_t, bf16_scales,
                         factors, offset)
        scales[:, gi] = s
        q[:, g0:g1] = torch.clamp(
            torch.round(wf[:, g0:g1] / s[:, None] - offset), qmin, qmax
        ).to(torch.int8)
    return q, scales


# record each group's column loop as a CUDA graph on the card and replay
# it (tests switch it off to hold the replay against the eager loop)
CUDA_GRAPHS = True


class _GroupStep:
    """One scale group of the error-feedback recurrence on fixed buffers:
    the group's scale, then each column's rounding, its error fed back
    onto the group's later columns (rank 1).

    A column takes about ten small ops, a launch from the host each. On
    the card the first call runs them and records them as a CUDA graph;
    later calls copy their group in and replay it: the same kernels on
    the same values, so the codes are those of the eager loop, without
    the host in the loop. Elsewhere every call runs the loop.
    """

    def __init__(self, out_f, width, device, qmin, qmax, div, offset,
                 bf16_scales, candidates):
        f32 = dict(dtype=torch.float32, device=device)
        self.w = torch.empty((out_f, width), **f32)  # fed back in place
        self.hdiag = torch.empty(width, **f32)
        self.u = torch.empty((width, width), **f32)
        self.udiag = torch.empty(width, **f32)
        self.s = torch.empty(out_f, **f32)
        self.q = torch.empty((out_f, width), **f32)
        self.err = torch.empty((out_f, width), **f32)
        self.div, self.factors = _scale_grid(div, candidates, device)
        self.qmin, self.qmax, self.offset = qmin, qmax, offset
        self.bf16_scales = bf16_scales
        self.graph = None
        self.record = torch.device(device).type == "cuda" and CUDA_GRAPHS

    def _run(self) -> None:
        qmin, qmax, offset = self.qmin, self.qmax, self.offset
        width = self.w.shape[1]
        s = _group_scale(self.w, qmin, qmax, self.div, self.bf16_scales,
                         self.factors, offset, self.hdiag)
        self.s.copy_(s)
        inv_s = torch.ones_like(s) / s
        for jj in range(width):
            wc = self.w[:, jj]
            # x - 0 and x + 0 are x: an offset of 0 costs no launch
            scaled = wc * inv_s
            qc = torch.clamp(
                torch.round(scaled - offset if offset else scaled),
                qmin, qmax, out=self.q[:, jj],
            )
            level = qc + offset if offset else qc
            err = torch.div(wc - level * s, self.udiag[jj],
                            out=self.err[:, jj])
            if jj + 1 < width:
                self.w[:, jj + 1:] -= torch.outer(err, self.u[jj, jj + 1:])

    def __call__(self, w, hdiag, u, udiag):
        """(scales, levels, whitened errors) of one group: views of the
        step's buffers, valid until its next call."""
        self.w.copy_(w)
        self.hdiag.copy_(hdiag)
        self.u.copy_(u)
        self.udiag.copy_(udiag)
        if self.graph is not None:
            self.graph.replay()
            return self.s, self.q, self.err
        self._run()
        if self.record:
            # recorded, not run: the buffers keep this call's results
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._run()
        return self.s, self.q, self.err


def _feedback(w, hessian, spans, qmin, qmax, div, offset, bf16_scales,
              candidates, damp, steps):
    """The error-feedback recurrence: per group the scale, then each
    column's rounding with its error fed back onto the group's later
    columns (rank 1; :class:`_GroupStep`), then the group's errors onto
    all later groups in one product."""
    out_f, in_f = w.shape
    dev = w.device
    u = _cholesky_inv_upper(hessian, damp)
    udiag = torch.diagonal(u).to(torch.float32)
    u32 = u.to(torch.float32)
    del u
    wrk = w.to(torch.float32, copy=True)
    hdiag = torch.diagonal(hessian).to(torch.float32)
    # dead inputs (never activated): zero, no feedback
    wrk.masked_fill_((hdiag <= 0)[None, :], 0.0)
    q = torch.zeros((out_f, in_f), dtype=torch.int8, device=dev)
    scales = torch.zeros((out_f, len(spans)), dtype=torch.float32, device=dev)
    for gi, (g0, g1) in enumerate(spans):
        key = (dev, out_f, g1 - g0, qmin, qmax, div, offset, bf16_scales,
               tuple(candidates))
        if key not in steps:
            steps[key] = _GroupStep(out_f, g1 - g0, dev, qmin, qmax, div,
                                    offset, bf16_scales, candidates)
        s, q_blk, err_blk = steps[key](
            wrk[:, g0:g1], hdiag[g0:g1], u32[g0:g1, g0:g1], udiag[g0:g1])
        scales[:, gi] = s
        q[:, g0:g1] = q_blk.to(torch.int8)
        if g1 < in_f:
            # the group's errors onto all later groups, in one product
            wrk[:, g1:] -= err_blk @ u32[g0:g1, g1:]
    return q, scales


def dequant_groups(
    q: torch.Tensor,
    scales: torch.Tensor,
    spans: List[Tuple[int, int]],
    offset: float = 0.0,
) -> torch.Tensor:
    """f32 dequant of (q, scales) over explicit group spans; levels are
    ``(q + offset) * s`` (offset 0.5 for int2)."""
    w = q.to(torch.float32) + offset
    for gi, (g0, g1) in enumerate(spans):
        w[:, g0:g1] *= scales[:, gi: gi + 1]
    return w


def output_error_ratio(
    w: torch.Tensor, w_hat: torch.Tensor, hessian: Optional[torch.Tensor]
) -> float:
    """Relative expected output error of a re-encode,
    ``tr(dW H dW^T) / tr(W H W^T)`` over the calibration inputs: f32
    products, f64 sums. With ``hessian=None`` the relative squared
    weight error."""
    dw = (w_hat - w).to(torch.float32)
    wf = w.to(torch.float32)
    if hessian is None:
        num = float(torch.sum(dw.to(torch.float64) ** 2))
        den = float(torch.sum(wf.to(torch.float64) ** 2))
    else:
        h = hessian.to(torch.float32)
        with true_f32():
            num = float(torch.sum((dw @ h).to(torch.float64)
                                  * dw.to(torch.float64)))
            den = float(torch.sum((wf @ h).to(torch.float64)
                                  * wf.to(torch.float64)))
    return num / den if den > 0 else 0.0
