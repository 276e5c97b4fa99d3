"""K3 ``w2_matmul``: 2-bit half-offset codes with per-(row, group) bf16 scales.

Port of ``vptq_tpu/ops/pallas_gemm.py:986-1215`` (``_w2_kernel``, entry
``w2_matmul``). The kernel is hand-written CUDA for Hopper in
``vptq_tpu_torch/csrc/w2_matmul.cu``: the decode GEMV of
``csrc/decode_gemv.cuh`` up to 16 tokens (``lowbit.cuh``'s GEMV for a
shape the plan gives no split), the prefill tile of
``csrc/lowbit_tile.cuh`` past them. :func:`w2_matmul` launches it for
CUDA tensors and runs the plain version :func:`w2_matmul_reference`
only for tensors that lie on the CPU. ``w2_matmul.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from vptq_tpu_torch.ops.scaled_matmul import (
    decode_route,
    grouped_reference,
    launch,
)
from vptq_tpu_torch.ops.packing import unpack_int2

__all__ = ["W2_GROUPS", "w2_matmul", "w2_matmul_reference"]

W2_GROUPS = (64, 128)  # scale groups the kernel takes
_TILE_POSITIONS = 128  # positions of one quarter in a stage of the tile


def _check(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor) -> int:
    """Validate shapes and dtypes; returns the scale group."""
    if wq.dtype != torch.int8 or wq.dim() != 2:
        raise ValueError(f"wq must be 2-D int8, got {wq.dtype} {tuple(wq.shape)}")
    out_f, in_p = wq.shape[0], wq.shape[1] * 4
    if scales.dtype != torch.bfloat16 or scales.dim() != 2:
        raise ValueError(f"scales must be 2-D bf16, got {scales.dtype}")
    n_groups = scales.shape[1]
    group = in_p // n_groups if n_groups and in_p % n_groups == 0 else 0
    if scales.shape[0] != out_f or group not in W2_GROUPS:
        raise ValueError(
            f"scales shape {tuple(scales.shape)} mismatch wq {tuple(wq.shape)}"
        )
    if in_p % (4 * group):
        raise ValueError(f"in_features {in_p} must be a multiple of {4 * group}")
    if not x.is_floating_point() or x.shape[-1] != in_p:
        raise ValueError(f"x must be floating point (..., {in_p})")
    return group


def w2_matmul_reference(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain torch version of K3: levels ``c + 0.5`` ∈ {±0.5, ±1.5} from
    the quarter-split plane, scale on each group's f32 partial."""
    group = _check(x, wq, scales)
    levels = unpack_int2(wq).to(torch.float32) + 0.5
    return grouped_reference(
        x, levels, scales.to(torch.float32), group, out_dtype
    )


def w2_matmul(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x @ ((unpack_int2(wq) + 0.5) ⊙ scales)ᵀ`` through the K3 kernel.

    x (..., in_p) float; wq (out, in_p / 4) int8 in the
    :func:`~vptq_tpu_torch.ops.packing.pack_int2` layout; scales
    (out, in_p / group) bf16 with group 64 or 128. Returns (..., out) in
    ``out_dtype`` (default ``x.dtype``).
    """
    group = _check(x, wq, scales)
    if x.device.type == "cpu":
        return w2_matmul_reference(x, wq, scales, out_dtype)
    if wq.shape[1] % _TILE_POSITIONS:
        # the prefill tile and the decode GEMV read 128 positions of each
        # quarter a stage; pack_int2 pads every layer to W2_BLOCK = 1024
        # columns
        raise ValueError(
            f"in_features {wq.shape[1] * 4} must be a multiple of "
            f"{4 * _TILE_POSITIONS} on the card"
        )
    # the decode GEMV's cluster size over the in_p / 4 positions; 0 sends a
    # shape it does not take to lowbit.cuh's GEMV
    split = decode_route(wq.shape[0], wq.shape[1], f"w2g{group}", x)
    y = launch(
        "w2_matmul", "vptq_w2_matmul", x, (wq, scales), (group, split),
        wq.shape[0], wq.shape[1] * 4, out_dtype,
    )
    w2_matmul.launches += 1
    return y


w2_matmul.launches = 0
# the TPU kernel this one replaces
w2_matmul.replaces = "vptq_tpu/ops/pallas_gemm.py:986"
# words of the demangled names of its CUDA kernels that pick them out of a
# trace, one set per family: lowbit.cuh's GEMV and lowbit_tile.cuh's
# prefill tile, and the decode GEMV (decode_gemv.cuh, with sel::Whole),
# each with the policy W2 of csrc/w2_matmul.cu
w2_matmul.trace_tags = (("lowbit", "W2"), ("decode_gemv", "W2", "Whole"))
