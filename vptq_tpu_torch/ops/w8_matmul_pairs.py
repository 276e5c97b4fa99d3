"""K5a ``w8_matmul_pairs``: K1's product, one expert per row of x.

Port of ``vptq_tpu/ops/pallas_gemm.py:315-439`` (``_w8p_kernel``, entry
``w8_matmul_pairs``): ``out[p] = x[p] @ (scales[e_p] ⊙ wq[e_p])^T`` for
all (token, expert) pairs of a MoE decode step in one launch. The ids
are an int32 tensor that stays on the device; the hand-written CUDA
kernel (``vptq_tpu_torch/csrc/w8_matmul_pairs.cu``: the decode GEMV of
``csrc/decode_gemv.cuh`` with the selection ``sel::Grouped``) groups the
pairs by expert on the card and streams each distinct expert's slab once
for all of its pairs, which are the product's columns; the host plans
the columns a pass, the rows a block and the cluster's split from P, E
and the shapes (``ops/scaled_matmul.py`` :func:`pairs_plan`). Up to two
pairs (:func:`takes_decode_gemv`, by P alone) the kernel runs w8.cuh's
GEMV instead, one pair a grid row, as before the grouped design.

:func:`w8_matmul_pairs` launches the kernel for CUDA tensors and runs
the plain version :func:`w8_matmul_pairs_reference` only for tensors
that lie on the CPU. ``w8_matmul_pairs.launches`` counts launches.
"""

from __future__ import annotations

import torch

from vptq_tpu_torch.ops.scaled_matmul import (
    DECODE_STAGE,
    PAIRS_GEMV_MAX,
    PAIRS_MAX_EXPERTS,
    check_pairs,
    launch,
    pairs_plan,
    sm_count,
)
from vptq_tpu_torch.ops.w8_matmul_expert import (
    check_stacked,
    w8_matmul_expert_reference,
)

__all__ = ["takes_decode_gemv", "w8_matmul_pairs",
           "w8_matmul_pairs_reference"]


def takes_decode_gemv(pairs: int, out_f=None, in_p=None) -> bool:
    """Whether a launch of ``pairs`` pairs runs the grouped decode GEMV
    (``decode_gemv.cuh``), by P alone: past :data:`PAIRS_GEMV_MAX` pairs;
    fewer run w8.cuh's GEMV, which is faster where every expert has one
    pair (``PERF.md``)."""
    return pairs > PAIRS_GEMV_MAX


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
    # the columns a pass, the rows a block and the cluster's split, from
    # P, E and the shapes; split 0 runs w8.cuh's GEMV
    cols, rows, split = pairs_plan(out_f, in_p, x.shape[0], n_experts,
                                   sm_count(x.device))
    if split and (group % DECODE_STAGE or n_experts > PAIRS_MAX_EXPERTS):
        raise ValueError(
            f"w8_matmul_pairs takes scale groups of whole {DECODE_STAGE}-"
            f"position stages (the loaders' 512 to 2048) and at most "
            f"{PAIRS_MAX_EXPERTS} experts, got group {group} and "
            f"{n_experts} experts")
    y = launch(
        "w8_matmul_pairs", "vptq_w8_matmul_pairs", x, (wq, scales),
        (group, n_experts, cols, rows, split), out_f, in_p, out_dtype,
        ids=experts.to(torch.int32).contiguous(),
    )
    w8_matmul_pairs.launches += 1
    return y


w8_matmul_pairs.launches = 0
# the TPU kernel this one replaces
w8_matmul_pairs.replaces = "vptq_tpu/ops/pallas_gemm.py:315"
# words of the demangled names of its CUDA kernels that pick them out of a
# profiler trace, one set per family: w8.cuh's GEMV with sel::Pairs (up to
# PAIRS_GEMV_MAX pairs), and decode_gemv.cuh's decode_gemv_grouped with
# the policies W8 and sel::Grouped
w8_matmul_pairs.trace_tags = (("w8_gem", "Pairs"),
                              ("decode_gemv", "W8", "Grouped"))
