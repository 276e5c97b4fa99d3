"""K5a ``w8_matmul_pairs``: K1's product, one expert per row of x.

Port of ``vptq_tpu/ops/pallas_gemm.py:315-439`` (``_w8p_kernel``, entry
``w8_matmul_pairs``): ``out[p] = x[p] @ (scales[e_p] ⊙ wq[e_p])^T`` for
all (token, expert) pairs of a MoE decode step in one launch, each pair
reading only its expert's bytes. The ids are an int32 tensor that stays
on the device; the hand-written CUDA kernel
(``vptq_tpu_torch/csrc/w8_matmul_pairs.cu``) reads ``ids[p]`` in the
block that serves pair p.

:func:`w8_matmul_pairs` launches the kernel for CUDA tensors and runs
the plain version :func:`w8_matmul_pairs_reference` only for tensors
that lie on the CPU. ``w8_matmul_pairs.launches`` counts launches.
"""

from __future__ import annotations

import torch

from vptq_tpu_torch.ops.scaled_matmul import check_pairs, launch
from vptq_tpu_torch.ops.w8_matmul_expert import (
    check_stacked,
    w8_matmul_expert_reference,
)

__all__ = ["w8_matmul_pairs", "w8_matmul_pairs_reference"]


def w8_matmul_pairs_reference(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    experts: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain torch version of K5a: each row through K6a's plain version."""
    check_stacked(x, wq, scales)
    check_pairs(x, experts)
    return torch.cat([
        w8_matmul_expert_reference(
            x[p: p + 1], wq, scales, experts[p], out_dtype
        )
        for p in range(x.shape[0])
    ])


def w8_matmul_pairs(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    experts: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``out[p] = x[p] @ (scales[e_p] ⊙ wq[e_p])^T`` through the K5a kernel.

    x (P, in_p) float; wq (E, out, in_p) int8; scales
    (E, in_p // group, out) f32; ``experts`` (P,) integer tensor on x's
    device with ids in [0, E). Returns (P, out) in ``out_dtype`` (default
    ``x.dtype``).
    """
    n_experts, out_f, in_p, group = check_stacked(x, wq, scales)
    check_pairs(x, experts)
    if x.device.type == "cpu":
        return w8_matmul_pairs_reference(x, wq, scales, experts, out_dtype)
    y = launch(
        "w8_matmul_pairs", "vptq_w8_matmul_pairs", x, (wq, scales),
        (group, n_experts), out_f, in_p, out_dtype,
        ids=experts.to(torch.int32).contiguous(),
    )
    w8_matmul_pairs.launches += 1
    return y


w8_matmul_pairs.launches = 0
# the TPU kernel this one replaces
w8_matmul_pairs.replaces = "vptq_tpu/ops/pallas_gemm.py:315"
# words of the demangled names of its CUDA kernels (w8.cuh's, with the
# policy sel::Pairs) that pick them out of a profiler trace
w8_matmul_pairs.trace_tags = ("w8_gem", "Pairs")
