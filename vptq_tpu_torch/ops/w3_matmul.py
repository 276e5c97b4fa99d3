"""K4 ``w3_matmul``: int3 in a 2-bit plane and a sign plane, per-(row,
128-column) bf16 scales.

Port of ``vptq_tpu/ops/pallas_gemm.py:1218-1454`` (``_w3_kernel``, entry
``w3_matmul``). The kernel is hand-written CUDA for Hopper in
``vptq_tpu_torch/csrc/w3_matmul.cu``: the decode GEMV of
``csrc/decode_gemv.cuh`` up to 16 tokens (``lowbit.cuh``'s GEMV for a
shape the plan gives no split), the prefill tile of
``csrc/lowbit_tile.cuh`` past them. :func:`w3_matmul` launches it for
CUDA tensors and runs the plain version :func:`w3_matmul_reference`
only for tensors that lie on the CPU. ``w3_matmul.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from vptq_tpu_torch.ops.scaled_matmul import (
    decode_route,
    grouped_reference,
    launch,
)
from vptq_tpu_torch.ops.packing import INT4_GROUP, W3_BLOCK, unpack_int3

__all__ = ["takes_decode_gemv", "w3_matmul", "w3_matmul_reference"]

# lowbit.cuh's GEMV is faster than the decode GEMV on o (4096 x 4096) at 1
# and 2 tokens (examples/decode_splits, flush r, one H100 at the four
# Llama-3.1-8B linears); a weight of at most that many entries goes to it
_GEMV_ENTRIES = 1 << 24


def takes_decode_gemv(tokens: int, out_f: int, in_p: int) -> bool:
    """Whether K4 sends ``tokens`` (1 to 16) of an (out_f, in_p) weight to
    the Hopper decode GEMV rather than to ``lowbit.cuh``'s GEMV: where it
    was measured the faster."""
    return 1 <= tokens <= 16 and not (
        tokens <= 2 and out_f * in_p <= _GEMV_ENTRIES)


def _check(x, wq2, wq1, scales) -> int:
    """Validate shapes and dtypes; returns the padded in_features."""
    if wq2.dtype != torch.int8 or wq2.dim() != 2:
        raise ValueError(f"wq2 must be 2-D int8, got {wq2.dtype}")
    out_f, in_p = wq2.shape[0], wq2.shape[1] * 4
    if in_p % W3_BLOCK:
        raise ValueError(f"in_features {in_p} must be a multiple of {W3_BLOCK}")
    if wq1.dtype != torch.int8 or tuple(wq1.shape) != (out_f, in_p // 8):
        raise ValueError(f"wq1 must be int8 {(out_f, in_p // 8)}")
    if scales.dtype != torch.bfloat16 or tuple(scales.shape) != (
        out_f, in_p // INT4_GROUP
    ):
        raise ValueError(
            f"scales must be bf16 {(out_f, in_p // INT4_GROUP)}, got "
            f"{scales.dtype} {tuple(scales.shape)}"
        )
    if not x.is_floating_point() or x.shape[-1] != in_p:
        raise ValueError(f"x must be floating point (..., {in_p})")
    return in_p


def w3_matmul_reference(
    x: torch.Tensor,
    wq2: torch.Tensor,
    wq1: torch.Tensor,
    scales: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain torch version of K4: levels ``two − 4·sign`` ∈ [−4, 3], scale
    on each 128-column group's f32 partial."""
    _check(x, wq2, wq1, scales)
    levels = unpack_int3(wq2, wq1).to(torch.float32)
    return grouped_reference(
        x, levels, scales.to(torch.float32), INT4_GROUP, out_dtype
    )


def w3_matmul(
    x: torch.Tensor,
    wq2: torch.Tensor,
    wq1: torch.Tensor,
    scales: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x @ (unpack_int3(wq2, wq1) ⊙ scales)ᵀ`` through the K4 kernel.

    x (..., in_p) float; wq2 (out, in_p / 4) and wq1 (out, in_p / 8) int8
    in the :func:`~vptq_tpu_torch.ops.packing.pack_int3` layout; scales
    (out, in_p / 128) bf16. Returns (..., out) in ``out_dtype`` (default
    ``x.dtype``).
    """
    in_p = _check(x, wq2, wq1, scales)
    if x.device.type == "cpu":
        return w3_matmul_reference(x, wq2, wq1, scales, out_dtype)
    # the decode GEMV's cluster size over the in_p / 8 positions; 0 sends a
    # shape it does not take, or one at a token count at which lowbit.cuh's
    # GEMV is faster, to that GEMV
    out_f = wq2.shape[0]
    split = (decode_route(out_f, in_p // 8, "w3", x)
             if takes_decode_gemv(x.numel() // in_p, out_f, in_p) else 0)
    y = launch(
        "w3_matmul", "vptq_w3_matmul", x, (wq2, wq1, scales), (split,),
        out_f, in_p, out_dtype,
    )
    w3_matmul.launches += 1
    return y


w3_matmul.launches = 0
# the TPU kernel this one replaces
w3_matmul.replaces = "vptq_tpu/ops/pallas_gemm.py:1218"
# words of the demangled names of its CUDA kernels that pick them out of a
# trace, one set per family: lowbit.cuh's GEMV and lowbit_tile.cuh's tile,
# and the decode GEMV (decode_gemv.cuh, with sel::Whole), each with the
# policy W3 of csrc/w3_matmul.cu
w3_matmul.trace_tags = (("lowbit", "W3"), ("decode_gemv", "W3", "Whole"))
