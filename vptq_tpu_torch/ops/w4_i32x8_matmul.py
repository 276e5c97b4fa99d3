"""P1c: an int4 GEMV over eight unsigned nibble planes per int32 word.

Port of the measurement kernel ``examples/w4_wall_candidates.py:124``
(``_i32x8_kernel``, entry ``run_variant``, mode ``"i32x8"``). The kernel
is hand-written CUDA for Hopper in
``vptq_tpu_torch/csrc/w4_i32x8_matmul.cu``. :func:`w4_i32x8_matmul`
launches it for CUDA tensors and runs the plain version
:func:`w4_i32x8_matmul_reference` only for tensors that lie on the CPU.
No layer calls it; the examples and ``chip_smoke.py`` do.

Layout: word m of a row lies in superblock ``m // 128`` of 1024 natural
columns; its bits ``4p … 4p+3`` hold the level (0 … 15, no +8
correction) of natural column ``1024·(m // 128) + 128·p + m % 128``.
"""

from __future__ import annotations

import torch

from vptq_tpu_torch.ops.packing import INT4_GROUP
from vptq_tpu_torch.ops.scaled_matmul import grouped_reference, launch

__all__ = ["SUPERBLOCK", "i32x8_levels", "w4_i32x8_matmul",
           "w4_i32x8_matmul_reference"]

SUPERBLOCK = 1024  # natural columns of 128 words: 8 planes of 128


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
    y = launch(
        "w4_i32x8_matmul", "vptq_w4_i32x8_matmul", x, (wq, scales), (),
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
w4_i32x8_matmul.trace_tags = ("i32x8_gemv",)
