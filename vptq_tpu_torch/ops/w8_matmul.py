"""K1 ``w8_matmul``: int8 weights with per-(in-group, out-row) f32 scales.

Port of ``vptq_tpu/ops/pallas_gemm.py:58-190`` (``_w8_kernel``, entry
``w8_matmul``). The kernel is hand-written CUDA for Hopper in
``vptq_tpu_torch/csrc/w8_matmul.cu``, built by ``ops/_build.py`` and
called through ``ctypes`` on PyTorch's current stream.

:func:`w8_matmul` launches it for CUDA tensors, and runs the plain
version :func:`w8_matmul_reference` only for tensors that lie on the
CPU. ``w8_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from vptq_tpu_torch.ops import _build

__all__ = ["w8_matmul", "w8_matmul_reference"]

_OUT_CODES = {torch.bfloat16: 0, torch.float32: 1}
_SIGNATURES = {
    "vptq_w8_matmul": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        ctypes.c_int,
    ),
}


def _check(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor) -> int:
    """Validate shapes and dtypes; returns the scale group."""
    if wq.dtype != torch.int8 or wq.dim() != 2:
        raise ValueError(
            f"wq must be 2-D int8, got {wq.dtype} {tuple(wq.shape)}"
        )
    if scales.dtype != torch.float32 or scales.dim() != 2:
        raise ValueError(f"scales must be 2-D float32, got {scales.dtype}")
    if not x.is_floating_point():
        raise ValueError(f"x must be floating point, got {x.dtype}")
    out_f, in_p = wq.shape
    n_groups = scales.shape[0]
    if scales.shape[1] != out_f or n_groups == 0 or in_p % n_groups:
        raise ValueError(
            f"scales shape {tuple(scales.shape)} mismatch wq {tuple(wq.shape)}"
        )
    if x.shape[-1] != in_p:
        raise ValueError(f"x last dim {x.shape[-1]} != in_p {in_p}")
    return in_p // n_groups


def w8_matmul_reference(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain torch version of K1, the same arithmetic as ``_w8_kernel``.

    x is rounded to bf16; each in-group's f32 partial product is scaled
    by ``scales[g, o]`` and the partials are summed in f32, group by
    group; the result is cast to ``out_dtype`` (default ``x.dtype``).
    """
    group = _check(x, wq, scales)
    out_f, in_p = wq.shape
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    xb = x.reshape(-1, in_p).to(torch.bfloat16).to(torch.float32)
    w = wq.to(torch.float32)
    acc = None
    for g in range(in_p // group):
        cols = slice(g * group, (g + 1) * group)
        part = torch.matmul(xb[:, cols], w[:, cols].t()) * scales[g][None, :]
        acc = part if acc is None else acc + part
    return acc.to(out_dtype).reshape(*lead, out_f)


def w8_matmul(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x @ (scales ⊙ wq)^T`` through the K1 kernel.

    x (..., in_p) float; wq (out, in_p) int8; scales (in_p // group, out)
    f32 with ``group % 32 == 0``. Returns (..., out) in ``out_dtype``
    (default ``x.dtype``).
    """
    group = _check(x, wq, scales)
    if x.device.type == "cpu":
        return w8_matmul_reference(x, wq, scales, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"w8_matmul runs on cuda or cpu, not {x.device}")
    if wq.device != x.device or scales.device != x.device:
        raise ValueError("x, wq and scales must be on one device")
    if not (wq.is_contiguous() and scales.is_contiguous()):
        raise ValueError("wq and scales must be contiguous")
    if group % 32:
        raise ValueError(f"scale group {group} must be a multiple of 32")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _OUT_CODES:
        raise ValueError(f"unsupported output dtype {out_dtype}")
    out_f, in_p = wq.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, in_p).to(torch.bfloat16).contiguous()
    tokens = x2.shape[0]
    y = torch.empty(tokens, out_f, dtype=out_dtype, device=x.device)
    if tokens == 0:
        return y.reshape(*lead, out_f)
    if x2.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("x and wq must be 16-byte aligned")
    lib = _build.load("w8_matmul", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.vptq_w8_matmul(
            x2.data_ptr(), wq.data_ptr(), scales.data_ptr(), y.data_ptr(),
            tokens, out_f, in_p, group, _OUT_CODES[out_dtype], stream,
        )
    if err:
        raise RuntimeError(f"w8_matmul kernel launch failed: CUDA error {err}")
    w8_matmul.launches += 1
    return y.reshape(*lead, out_f)


w8_matmul.launches = 0
