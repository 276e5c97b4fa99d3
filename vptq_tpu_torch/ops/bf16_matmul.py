"""K7 ``bf16_matmul``: ``x @ wᵀ`` on bf16 operands with f32 accumulation.

Port of ``vptq_tpu/ops/pallas_gemm.py:905-983`` (``_bf16_kernel``, entry
``bf16_matmul``), the tile kernel of the exact-parity runtime format. The
kernel is hand-written CUDA for Hopper in
``vptq_tpu_torch/csrc/bf16_matmul.cu``: a GEMV for T ≤ 16 (helpers from
``csrc/w8.cuh``), and above it the Hopper prefill tile of
``csrc/lowbit_tile.cuh`` in its SS form (both ``wgmma`` operands from
shared memory). It is built by ``ops/_build.py`` and called through
``ctypes`` on PyTorch's current stream.

Neither package's layers call it: ``DenseLinear`` is a plain product
(``jnp.dot`` there, ``torch.matmul`` here). It is kept as an op, as the
JAX package keeps it.

:func:`bf16_matmul` launches the kernel for CUDA tensors, and runs the
plain version :func:`bf16_matmul_reference` only for tensors that lie on
the CPU. ``bf16_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from vptq_tpu_torch.ops.scaled_matmul import launch

__all__ = ["IN_TILE", "bf16_matmul", "bf16_matmul_reference"]

# in_features must divide into tiles of this many columns, as the TPU
# kernel's in-tile
IN_TILE = 512


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if w.dtype != torch.bfloat16 or w.dim() != 2:
        raise ValueError(
            f"w must be 2-D bfloat16, got {w.dtype} {tuple(w.shape)}"
        )
    if not x.is_floating_point():
        raise ValueError(f"x must be floating point, got {x.dtype}")
    in_f = w.shape[1]
    if in_f == 0 or in_f % IN_TILE:
        raise ValueError(f"in_features {in_f} % {IN_TILE} != 0")
    if x.shape[-1] != in_f:
        raise ValueError(f"x last dim {x.shape[-1]} != in_features {in_f}")


def bf16_matmul_reference(
    x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """Plain torch version of K7: x rounded to bf16, exact products summed
    in f32, the sum cast to ``out_dtype`` (default ``x.dtype``)."""
    _check(x, w)
    y = torch.matmul(
        x.to(torch.bfloat16).to(torch.float32), w.to(torch.float32).t()
    )
    return y.to(out_dtype or x.dtype)


def bf16_matmul(
    x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype | None = None
) -> torch.Tensor:
    """``x @ wᵀ`` through the K7 kernel.

    x (..., in) float, rounded to bf16; w (out, in) bf16 with
    ``in % 512 == 0``. Returns (..., out) in ``out_dtype`` (default
    ``x.dtype``).
    """
    _check(x, w)
    if x.device.type == "cpu":
        return bf16_matmul_reference(x, w, out_dtype)
    if w.data_ptr() % 16:
        raise ValueError("bf16_matmul: w must be 16-byte aligned")
    y = launch(
        "bf16_matmul", "vptq_bf16_matmul", x, (w,), (), w.shape[0],
        w.shape[1], out_dtype,
    )
    bf16_matmul.launches += 1
    return y


bf16_matmul.launches = 0
# the TPU kernel this one replaces
bf16_matmul.replaces = "vptq_tpu/ops/pallas_gemm.py:905"
# words of the demangled names of its CUDA kernels: the GEMV, and the
# tile's instances with the policy bf16mm::BF16
bf16_matmul.trace_tags = (("bf16_gemv",), ("wg_tile", "BF16"))
