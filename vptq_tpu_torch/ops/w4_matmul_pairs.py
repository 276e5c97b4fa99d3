"""K5b ``w4_matmul_pairs``: K2's product, one expert per row of x.

Port of ``vptq_tpu/ops/pallas_gemm.py:766-902`` (``_w4p_kernel``, entry
``w4_matmul_pairs``): ``out[p] = x[p] @ (scales[e_p]ᵀ ⊙
unpack_int4(wq[e_p]))ᵀ`` for all (token, expert) pairs of a MoE decode
step in one launch. The ids are an int32 tensor that stays on the
device; the hand-written CUDA kernel
(``vptq_tpu_torch/csrc/w4_matmul_pairs.cu``) reads ``ids[p]`` in the
block that serves pair p.

:func:`w4_matmul_pairs` launches the kernel for CUDA tensors and runs
the plain version :func:`w4_matmul_pairs_reference` only for tensors
that lie on the CPU. ``w4_matmul_pairs.launches`` counts launches.
"""

from __future__ import annotations

import torch

from vptq_tpu_torch.ops.scaled_matmul import check_pairs, launch
from vptq_tpu_torch.ops.w4_matmul_expert import (
    check_stacked,
    w4_matmul_expert_reference,
)

__all__ = ["w4_matmul_pairs", "w4_matmul_pairs_reference"]


def w4_matmul_pairs_reference(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    experts: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain torch version of K5b: each row through K6b's plain version."""
    check_stacked(x, wq, scales)
    check_pairs(x, experts)
    return torch.cat([
        w4_matmul_expert_reference(
            x[p: p + 1], wq, scales, experts[p], out_dtype
        )
        for p in range(x.shape[0])
    ])


def w4_matmul_pairs(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    experts: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``out[p] = x[p] @ (scales[e_p]ᵀ ⊙ unpack_int4(wq[e_p]))ᵀ`` through
    the K5b kernel.

    x (P, in_p) float; wq (E, out, in_p / 2) int8; scales
    (E, in_p / 128, out) bf16; ``experts`` (P,) integer tensor on x's
    device with ids in [0, E). Returns (P, out) in ``out_dtype`` (default
    ``x.dtype``).
    """
    n_experts, out_f, in_p = check_stacked(x, wq, scales)
    check_pairs(x, experts)
    if x.device.type == "cpu":
        return w4_matmul_pairs_reference(x, wq, scales, experts, out_dtype)
    y = launch(
        "w4_matmul_pairs", "vptq_w4_matmul_pairs", x, (wq, scales),
        (n_experts,), out_f, in_p, out_dtype,
        ids=experts.to(torch.int32).contiguous(),
    )
    w4_matmul_pairs.launches += 1
    return y


w4_matmul_pairs.launches = 0
# the TPU kernel this one replaces
w4_matmul_pairs.replaces = "vptq_tpu/ops/pallas_gemm.py:766"
# words of the demangled names of its CUDA kernels (lowbit.cuh's, with
# the policies W4 and sel::Pairs) that pick them out of a trace
w4_matmul_pairs.trace_tags = ("lowbit", "W4", "Pairs")
