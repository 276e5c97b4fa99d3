"""K6a ``w8_matmul_expert``: K1's product on one expert of a stack.

Port of ``vptq_tpu/ops/pallas_gemm.py:193-312`` (``_w8e_kernel``, entry
``w8_matmul_expert``): ``x @ (scales[e] ⊙ wq[e])^T`` over stacked
``(E, out, in_p)`` int8 experts, reading only expert ``e``'s bytes. The
id is an int32 tensor that stays on the device: the hand-written CUDA
kernel (``vptq_tpu_torch/csrc/w8_matmul_expert.cu``, K1's loops of
``csrc/w8.cuh`` entered with an expert offset; past 16 tokens the Hopper
tile of ``csrc/lowbit_tile.cuh``, whose weight map is 3-D over the stack
with the id as its third coordinate) reads it itself.

:func:`w8_matmul_expert` launches the kernel for CUDA tensors and runs
the plain version :func:`w8_matmul_expert_reference` only for tensors
that lie on the CPU. ``w8_matmul_expert.launches`` counts launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vptq_tpu_torch.ops.scaled_matmul import launch, pick_expert
from vptq_tpu_torch.ops.w8_matmul import w8_matmul_reference

__all__ = ["w8_matmul_expert", "w8_matmul_expert_reference"]


def check_stacked(
    x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor
) -> Tuple[int, int, int, int]:
    """Validate stacked int8 experts; returns (E, out, in_p, group)."""
    if wq.dtype != torch.int8 or wq.dim() != 3:
        raise ValueError(
            f"wq must be 3-D int8 (E, out, in_p), got {wq.dtype} "
            f"{tuple(wq.shape)}"
        )
    n_experts, out_f, in_p = wq.shape
    if scales.dtype != torch.float32 or scales.dim() != 3:
        raise ValueError(f"scales must be 3-D float32, got {scales.dtype}")
    n_groups = scales.shape[1]
    if (
        scales.shape[0] != n_experts or scales.shape[2] != out_f
        or n_groups == 0 or in_p % n_groups
    ):
        raise ValueError(
            f"scales shape {tuple(scales.shape)} mismatch wq {tuple(wq.shape)}"
        )
    if not x.is_floating_point() or x.shape[-1] != in_p:
        raise ValueError(f"x must be floating point (..., {in_p})")
    group = in_p // n_groups
    if x.device.type != "cpu":
        if group % 32:
            raise ValueError(f"scale group {group} must be a multiple of 32")
        # the kernels read every expert slab with 16-byte loads
        if (out_f * in_p) % 16:
            raise ValueError("expert slabs must be 16 bytes apart")
    return n_experts, out_f, in_p, group


def w8_matmul_expert_reference(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    expert: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain torch version of K6a: K1's plain version on a copy of the
    expert's slab."""
    check_stacked(x, wq, scales)
    return w8_matmul_reference(
        x, pick_expert(wq, expert), pick_expert(scales, expert), out_dtype
    )


def w8_matmul_expert(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    expert: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x @ (scales[e] ⊙ wq[e])^T`` through the K6a kernel.

    x (..., in_p) float, any number of rows; wq (E, out, in_p) int8;
    scales (E, in_p // group, out) f32; ``expert`` a one-element integer
    tensor on x's device holding e ∈ [0, E). Returns (..., out) in
    ``out_dtype`` (default ``x.dtype``).
    """
    n_experts, out_f, in_p, group = check_stacked(x, wq, scales)
    if expert.numel() != 1:
        raise ValueError(f"expert must hold one id, got {tuple(expert.shape)}")
    if x.device.type == "cpu":
        return w8_matmul_expert_reference(x, wq, scales, expert, out_dtype)
    y = launch(
        "w8_matmul_expert", "vptq_w8_matmul_expert", x, (wq, scales),
        (group, n_experts), out_f, in_p, out_dtype,
        ids=expert.reshape(1).to(torch.int32),
    )
    w8_matmul_expert.launches += 1
    return y


w8_matmul_expert.launches = 0
# the TPU kernel this one replaces
w8_matmul_expert.replaces = "vptq_tpu/ops/pallas_gemm.py:193"
# words of the demangled names of its CUDA kernels that pick them out of a
# profiler trace, one set per family: w8.cuh's w8_gemv and w8_gemm, and
# the prefill tile with the policy W8, each with sel::Expert
w8_matmul_expert.trace_tags = (
    ("w8_gem", "Expert"), ("wg_tile", "W8", "Expert"),
)
