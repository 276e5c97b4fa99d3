"""K2 ``w4_matmul``: packed int4 weights with per-(128-column, row) bf16 scales.

Port of ``vptq_tpu/ops/pallas_gemm.py:445-623`` (``_w4_kernel``, entry
``w4_matmul``). The kernel is hand-written CUDA for Hopper in
``vptq_tpu_torch/csrc/w4_matmul.cu``: the decode GEMV of
``csrc/decode_gemv.cuh`` up to 16 tokens, the prefill tile of
``csrc/lowbit_tile.cuh`` past them. :func:`w4_matmul` launches it for
CUDA tensors and runs the plain version :func:`w4_matmul_reference`
only for tensors that lie on the CPU. ``w4_matmul.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from vptq_tpu_torch.ops.scaled_matmul import (
    decode_route,
    grouped_reference,
    launch,
)
from vptq_tpu_torch.ops.packing import INT4_GROUP, unpack_int4

__all__ = ["w4_matmul", "w4_matmul_reference"]


def _check(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor) -> int:
    """Validate shapes and dtypes; returns the padded in_features."""
    if wq.dtype != torch.int8 or wq.dim() != 2:
        raise ValueError(f"wq must be 2-D int8, got {wq.dtype} {tuple(wq.shape)}")
    out_f, in_p = wq.shape[0], wq.shape[1] * 2
    if in_p % (2 * INT4_GROUP):
        raise ValueError(f"in_features {in_p} must be a multiple of 256")
    if scales.dtype != torch.bfloat16 or tuple(scales.shape) != (
        in_p // INT4_GROUP, out_f
    ):
        raise ValueError(
            f"scales must be bf16 {(in_p // INT4_GROUP, out_f)}, got "
            f"{scales.dtype} {tuple(scales.shape)}"
        )
    if not x.is_floating_point() or x.shape[-1] != in_p:
        raise ValueError(f"x must be floating point (..., {in_p})")
    return in_p


def w4_matmul_reference(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain torch version of K2: levels −8…7 from the split-half nibbles,
    scale ``scales[g, o]`` on each 128-column group's f32 partial."""
    _check(x, wq, scales)
    levels = unpack_int4(wq).to(torch.float32)
    return grouped_reference(
        x, levels, scales.to(torch.float32).t(), INT4_GROUP, out_dtype
    )


def w4_matmul(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x @ (scalesᵀ ⊙ unpack_int4(wq))ᵀ`` through the K2 kernel.

    x (..., in_p) float; wq (out, in_p / 2) int8 in the
    :func:`~vptq_tpu_torch.ops.packing.pack_int4` layout; scales
    (in_p / 128, out) bf16. Returns (..., out) in ``out_dtype`` (default
    ``x.dtype``).
    """
    in_p = _check(x, wq, scales)
    if x.device.type == "cpu":
        return w4_matmul_reference(x, wq, scales, out_dtype)
    # the decode GEMV's cluster size over the in_p / 2 byte positions; 0
    # sends a shape it does not take to lowbit.cuh's GEMV
    split = decode_route(wq.shape[0], in_p // 2, "w4", x)
    y = launch(
        "w4_matmul", "vptq_w4_matmul", x, (wq, scales), (split,),
        wq.shape[0], in_p, out_dtype,
    )
    w4_matmul.launches += 1
    return y


w4_matmul.launches = 0
# the TPU kernel this one replaces
w4_matmul.replaces = "vptq_tpu/ops/pallas_gemm.py:445"
# words of the demangled names of its CUDA kernels that pick them out of a
# trace, one set per family: lowbit.cuh's GEMV and lowbit_tile.cuh's
# prefill tile, and the decode GEMV (decode_gemv.cuh), each with the
# policy W4 of csrc/w4.cuh and sel::Whole (K5b's pairs run the same
# kernels with sel::Pairs)
w4_matmul.trace_tags = (("lowbit", "W4", "Whole"),
                        ("decode_gemv", "W4", "Whole"))
