"""P1c: an int4 GEMV over eight unsigned nibble planes per int32 word.

Port of the measurement kernel ``examples/w4_wall_candidates.py:124``
(``_i32x8_kernel``, entry ``run_variant``, mode ``"i32x8"``). The kernel
is hand-written CUDA for Hopper in
``vptq_tpu_torch/csrc/w4_i32x8_matmul.cu`` on the asynchronous ring of
``csrc/ring_gemv.cuh``: the words stream through a ``cp.async`` ring, a
magic-number unpack (``prmt``, ``lop3``, one ``fma.rn.bf16x2``) makes
bf16 pairs of one plane, and the products run on tensor cores
(``mma.sync``). :func:`w4_i32x8_matmul` launches it for CUDA tensors,
with the token tile and cluster size that :func:`i32x8_plan` plans, and
runs the plain version :func:`w4_i32x8_matmul_reference` only for tensors
that lie on the CPU. No layer calls it; the examples and
``chip_smoke.py`` do.

Layout: word m of a row lies in superblock ``m // 128`` of 1024 natural
columns; its bits ``4p … 4p+3`` hold the level (0 … 15, no +8
correction) of natural column ``1024·(m // 128) + 128·p + m % 128``.
"""

from __future__ import annotations

import torch

from vptq_tpu_torch.ops.packing import INT4_GROUP
from vptq_tpu_torch.ops.scaled_matmul import (
    grouped_reference, launch, ring_plan, sm_count,
)

__all__ = ["SUPERBLOCK", "i32x8_levels", "i32x8_plan", "i32x8_rows",
           "i32x8_smem",
           "w4_i32x8_matmul", "w4_i32x8_matmul_reference"]

SUPERBLOCK = 1024  # natural columns of 128 words: 8 planes of 128
# the kernel's block (csrc/w4_i32x8_matmul.cu): 32 rows up to 8 tokens, 64
# past them, a ring of four stages of 128 bytes a row; a cluster splits a
# row's superblocks


def i32x8_rows(tokens: int) -> int:
    """Rows of one block of the kernel at ``tokens`` (its token tile)."""
    return 32 if tokens <= 8 else 64


def i32x8_smem(tokens: int, superblocks: int) -> int:
    """Shared memory of one block of the kernel whose range is
    ``superblocks`` superblocks (bytes): its ring, x for ``tokens`` rows,
    the scales of its rows (eight bf16 a superblock) and the partials the
    cluster's ranks push (one f32 a row and token)."""
    rows = i32x8_rows(tokens)
    return (256 + 4 * rows * 128 + tokens * superblocks * SUPERBLOCK * 2
            + superblocks * 8 * rows * 2 + rows * tokens * 4)


def i32x8_plan(out_f: int, in_f: int, tokens: int, n_sm: int) -> tuple:
    """(token tile, cluster size) a launch passes the kernel
    (``ring_plan`` over a row's superblocks); the size is 0 where no split
    fits x into a block."""
    return ring_plan(out_f, in_f // SUPERBLOCK, tokens, n_sm, i32x8_smem,
                     i32x8_rows)


def _check(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor) -> int:
    """Validate shapes and dtypes; returns in_features."""
    if wq.dtype != torch.int32 or wq.dim() != 2:
        raise ValueError(f"wq must be 2-D int32, got {wq.dtype} {tuple(wq.shape)}")
    out_f, in_f = wq.shape[0], wq.shape[1] * 8
    if in_f % SUPERBLOCK:
        raise ValueError(f"in_features {in_f} must be a multiple of {SUPERBLOCK}")
    if scales.dtype != torch.bfloat16 or tuple(scales.shape) != (
        in_f // INT4_GROUP, out_f
    ):
        raise ValueError(
            f"scales must be bf16 {(in_f // INT4_GROUP, out_f)}, got "
            f"{scales.dtype} {tuple(scales.shape)}"
        )
    if not x.is_floating_point() or x.shape[-1] != in_f:
        raise ValueError(f"x must be floating point (..., {in_f})")
    return in_f


def i32x8_levels(wq: torch.Tensor) -> torch.Tensor:
    """(out, in) int32 levels 0 … 15 in natural column order. torch's
    ``>>`` on int32 is arithmetic, so each plane is masked with 15 after
    its shift (plane 7 too)."""
    out_f = wq.shape[0]
    words = wq.reshape(out_f, -1, 1, SUPERBLOCK // 8)
    shifts = 4 * torch.arange(8, device=wq.device, dtype=torch.int32)
    planes = (words >> shifts[None, None, :, None]) & 15
    return planes.reshape(out_f, -1)


def w4_i32x8_matmul_reference(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain torch version: levels 0 … 15, scale ``scales[c // 128, o]``
    on each 128-column group's f32 partial."""
    _check(x, wq, scales)
    levels = i32x8_levels(wq).to(torch.float32)
    return grouped_reference(
        x, levels, scales.to(torch.float32).t(), INT4_GROUP, out_dtype
    )


def w4_i32x8_matmul(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x @ (scalesᵀ ⊙ i32x8_levels(wq))ᵀ`` through the P1c kernel.

    x (..., in) float, rounded to bf16; wq (out, in / 8) int32; scales
    (in / 128, out) bf16. Returns (..., out) in ``out_dtype`` (default
    ``x.dtype``).
    """
    in_f = _check(x, wq, scales)
    if x.device.type == "cpu":
        return w4_i32x8_matmul_reference(x, wq, scales, out_dtype)
    tokens = x.numel() // in_f
    tile, split = i32x8_plan(wq.shape[0], in_f, max(tokens, 1),
                             sm_count(x.device))
    if not split:
        raise ValueError(
            f"w4_i32x8_matmul: in_features {in_f} is too wide for the "
            "kernel's shared memory")
    y = launch(
        "w4_i32x8_matmul", "vptq_w4_i32x8_matmul", x, (wq, scales),
        (split, tile),
        wq.shape[0], in_f, out_dtype,
    )
    w4_i32x8_matmul.launches += 1
    return y


w4_i32x8_matmul.launches = 0
# the TPU kernel this one replaces
w4_i32x8_matmul.bodies = {"i32x8": "examples/w4_wall_candidates.py:124"}
w4_i32x8_matmul.replaces = w4_i32x8_matmul.bodies["i32x8"]
# the word of the demangled name of its CUDA kernel that picks it out of a
# trace
w4_i32x8_matmul.trace_tags = ("i32x8", "ring_gemv")
