"""K1 ``w8_matmul``: int8 weights with per-(in-group, out-row) f32 scales.

Port of ``vptq_tpu/ops/pallas_gemm.py:58-190`` (``_w8_kernel``, entry
``w8_matmul``). The kernel is hand-written CUDA for Hopper in
``vptq_tpu_torch/csrc/w8_matmul.cu`` (loops in ``csrc/w8.cuh``: for a
scale group of whole 128-column stages the Hopper decode GEMV of
``csrc/decode_gemv.cuh`` up to 16 tokens and the Hopper prefill tile of
``csrc/lowbit_tile.cuh`` past them; for any other group, which no loader
makes, ``w8.cuh``'s GEMV and an ``mma.sync`` tile), built by
``ops/_build.py`` and called through ``ctypes`` on PyTorch's current
stream.

:func:`w8_matmul` launches it for CUDA tensors, and runs the plain
version :func:`w8_matmul_reference` only for tensors that lie on the
CPU. ``w8_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from vptq_tpu_torch.ops.scaled_matmul import (
    DECODE_STAGE,
    decode_route,
    grouped_reference,
    launch,
)

__all__ = ["takes_decode_gemv", "w8_matmul", "w8_matmul_reference"]

# w8.cuh's w8_gemv is faster than the decode GEMV up to this many tokens on a
# clean L2, as a decode step finds it (examples/decode_splits, flush r, one
# H100, the four Llama-3.1-8B linears summed); from the next count on the
# decode GEMV is, or the two are even
_W8_GEMV_TOKENS = 2


def takes_decode_gemv(tokens: int, out_f: int, in_p: int) -> bool:
    """Whether K1 sends ``tokens`` of an (out_f, in_p) weight whose scale
    group is whole 128-column stages to the Hopper decode GEMV rather than
    to ``w8_gemv``: from 3 to 16 tokens, at every shape."""
    return _W8_GEMV_TOKENS < tokens <= 16


def _check(x: torch.Tensor, wq: torch.Tensor, scales: torch.Tensor) -> int:
    """Validate shapes and dtypes; returns the scale group."""
    if wq.dtype != torch.int8 or wq.dim() != 2:
        raise ValueError(
            f"wq must be 2-D int8, got {wq.dtype} {tuple(wq.shape)}"
        )
    if scales.dtype != torch.float32 or scales.dim() != 2:
        raise ValueError(f"scales must be 2-D float32, got {scales.dtype}")
    if not x.is_floating_point():
        raise ValueError(f"x must be floating point, got {x.dtype}")
    out_f, in_p = wq.shape
    n_groups = scales.shape[0]
    if scales.shape[1] != out_f or n_groups == 0 or in_p % n_groups:
        raise ValueError(
            f"scales shape {tuple(scales.shape)} mismatch wq {tuple(wq.shape)}"
        )
    if x.shape[-1] != in_p:
        raise ValueError(f"x last dim {x.shape[-1]} != in_p {in_p}")
    return in_p // n_groups


def w8_matmul_reference(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain torch version of K1, the same arithmetic as ``_w8_kernel``.

    x is rounded to bf16; each in-group's f32 partial product is scaled
    by ``scales[g, o]`` and the partials are summed in f32, group by
    group; the result is cast to ``out_dtype`` (default ``x.dtype``).
    """
    group = _check(x, wq, scales)
    return grouped_reference(
        x, wq.to(torch.float32), scales.t(), group, out_dtype
    )


def w8_matmul(
    x: torch.Tensor,
    wq: torch.Tensor,
    scales: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x @ (scales ⊙ wq)^T`` through the K1 kernel.

    x (..., in_p) float; wq (out, in_p) int8; scales (in_p // group, out)
    f32 with ``group % 32 == 0`` (the loaders' groups, 512 to 2048, are
    the ones the Hopper tile takes past 16 tokens). Returns (..., out) in
    ``out_dtype`` (default ``x.dtype``).
    """
    group = _check(x, wq, scales)
    if x.device.type == "cpu":
        return w8_matmul_reference(x, wq, scales, out_dtype)
    if group % 32:
        raise ValueError(f"scale group {group} must be a multiple of 32")
    out_f, in_p = wq.shape
    # the decode GEMV's cluster size, by shape; 0 sends a group of no whole
    # stages, a token count at which w8.cuh's GEMV is faster, or a shape
    # the decode GEMV does not take to w8.cuh's GEMV
    tokens = x.numel() // in_p
    split = (decode_route(out_f, in_p, "w8", x)
             if group % DECODE_STAGE == 0
             and takes_decode_gemv(tokens, out_f, in_p) else 0)
    y = launch(
        "w8_matmul", "vptq_w8_matmul", x, (wq, scales), (group, split),
        out_f, in_p, out_dtype,
    )
    w8_matmul.launches += 1
    return y


w8_matmul.launches = 0
# the TPU kernel this one replaces
w8_matmul.replaces = "vptq_tpu/ops/pallas_gemm.py:58"
# words of the demangled names of its CUDA kernels that pick them out of a
# trace, one set per family: w8.cuh's w8_gemv and w8_gemm and the prefill
# tile (lowbit_tile.cuh) with the policy W8, and the decode GEMV
# (decode_gemv.cuh) with the policy W8, each with sel::Whole
w8_matmul.trace_tags = (
    ("w8_gem", "Whole"), ("wg_tile", "W8", "Whole"),
    ("decode_gemv", "W8", "Whole"),
)
