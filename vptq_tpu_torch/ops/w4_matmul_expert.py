"""K6b ``w4_matmul_expert``: K2's product on one expert of a stack.

Port of ``vptq_tpu/ops/pallas_gemm.py:626-763`` (``_w4e_kernel``, entry
``w4_matmul_expert``): ``x @ (scales[e]ᵀ ⊙ unpack_int4(wq[e]))ᵀ`` over
stacked ``(E, out, in_p / 2)`` split-half nibble experts, reading only
expert ``e``'s bytes. The id is an int32 tensor that stays on the
device: the hand-written CUDA kernel
(``vptq_tpu_torch/csrc/w4_matmul_expert.cu``, K2's loops of
``csrc/lowbit.cuh`` entered with an expert offset) reads it itself.

:func:`w4_matmul_expert` launches the kernel for CUDA tensors and runs
the plain version :func:`w4_matmul_expert_reference` only for tensors
that lie on the CPU. ``w4_matmul_expert.launches`` counts launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vptq_tpu_torch.ops.packing import INT4_GROUP
from vptq_tpu_torch.ops.scaled_matmul import launch, pick_expert
from vptq_tpu_torch.ops.w4_matmul import w4_matmul_reference

__all__ = ["w4_matmul_expert", "w4_matmul_expert_reference"]


def check_stacked(
    x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor
) -> Tuple[int, int, int]:
    """Validate stacked int4 experts; returns (E, out, in_p)."""
    if wq.dtype != torch.int8 or wq.dim() != 3:
        raise ValueError(
            f"wq must be 3-D int8 (E, out, in_p / 2), got {wq.dtype} "
            f"{tuple(wq.shape)}"
        )
    n_experts, out_f, in_p = wq.shape[0], wq.shape[1], wq.shape[2] * 2
    if in_p % (2 * INT4_GROUP):
        raise ValueError(f"in_features {in_p} must be a multiple of 256")
    want = (n_experts, in_p // INT4_GROUP, out_f)
    if scales.dtype != torch.bfloat16 or tuple(scales.shape) != want:
        raise ValueError(
            f"scales must be bf16 {want}, got {scales.dtype} "
            f"{tuple(scales.shape)}"
        )
    if not x.is_floating_point() or x.shape[-1] != in_p:
        raise ValueError(f"x must be floating point (..., {in_p})")
    # the kernels read every expert slab with 16-byte loads
    if x.device.type != "cpu" and (out_f * (in_p // 2)) % 16:
        raise ValueError("expert slabs must be 16 bytes apart")
    return n_experts, out_f, in_p


def w4_matmul_expert_reference(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    expert: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain torch version of K6b: K2's plain version on a copy of the
    expert's slab."""
    check_stacked(x, wq, scales)
    return w4_matmul_reference(
        x, pick_expert(wq, expert), pick_expert(scales, expert), out_dtype
    )


def w4_matmul_expert(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    expert: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x @ (scales[e]ᵀ ⊙ unpack_int4(wq[e]))ᵀ`` through the K6b kernel.

    x (..., in_p) float, any number of rows; wq (E, out, in_p / 2) int8
    in the :func:`~vptq_tpu_torch.ops.packing.pack_int4` layout; scales
    (E, in_p / 128, out) bf16; ``expert`` a one-element integer tensor on
    x's device holding e ∈ [0, E). Returns (..., out) in ``out_dtype``
    (default ``x.dtype``).
    """
    n_experts, out_f, in_p = check_stacked(x, wq, scales)
    if expert.numel() != 1:
        raise ValueError(f"expert must hold one id, got {tuple(expert.shape)}")
    if x.device.type == "cpu":
        return w4_matmul_expert_reference(x, wq, scales, expert, out_dtype)
    y = launch(
        "w4_matmul_expert", "vptq_w4_matmul_expert", x, (wq, scales),
        (n_experts,), out_f, in_p, out_dtype,
        ids=expert.reshape(1).to(torch.int32),
    )
    w4_matmul_expert.launches += 1
    return y


w4_matmul_expert.launches = 0
# the TPU kernel this one replaces
w4_matmul_expert.replaces = "vptq_tpu/ops/pallas_gemm.py:626"
# words of the demangled names of its CUDA kernels (lowbit.cuh's, with
# the policies W4 and sel::Expert) that pick them out of a trace
w4_matmul_expert.trace_tags = ("lowbit", "W4", "Expert")
