"""K1 ``w8_matmul``: int8 weights with per-(in-group, out-row) f32 scales.

Port of ``vptq_tpu/ops/pallas_gemm.py:58-190`` (``_w8_kernel``, entry
``w8_matmul``). The kernel is hand-written CUDA for Hopper in
``vptq_tpu_torch/csrc/w8_matmul.cu`` (loops in ``csrc/w8.cuh``), built
by ``ops/_build.py`` and called through ``ctypes`` on PyTorch's current
stream.

:func:`w8_matmul` launches it for CUDA tensors, and runs the plain
version :func:`w8_matmul_reference` only for tensors that lie on the
CPU. ``w8_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from vptq_tpu_torch.ops.scaled_matmul import grouped_reference, launch

__all__ = ["w8_matmul", "w8_matmul_reference"]


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
    return grouped_reference(
        x, wq.to(torch.float32), scales.t(), group, out_dtype
    )


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
    if group % 32:
        raise ValueError(f"scale group {group} must be a multiple of 32")
    y = launch(
        "w8_matmul", "vptq_w8_matmul", x, (wq, scales), (group,),
        wq.shape[0], wq.shape[1], out_dtype,
    )
    w8_matmul.launches += 1
    return y


w8_matmul.launches = 0
# the TPU kernel this one replaces
w8_matmul.replaces = "vptq_tpu/ops/pallas_gemm.py:58"
# words of the demangled names of its CUDA kernels (w8.cuh's w8_gemv and
# w8_gemm, with the policy sel::Whole) that pick them out of a trace
w8_matmul.trace_tags = ("w8_gem", "Whole")
