"""Host side shared by the group-scaled dequant-matmul kernels.

K1 ``w8_matmul`` (``csrc/w8_matmul.cu``) and K2 ``w4_matmul``, K3
``w2_matmul`` and K4 ``w3_matmul`` (``csrc/w{4,2,3}_matmul.cu``, on the
skeleton ``csrc/lowbit.cuh``) compute one function: ``y = x @ (s ⊙ L)^T``
where ``L`` holds each weight's exact level and ``s`` one scale per
(row, column group). x is rounded to bf16, the products of each group
are summed in f32, the group's scale multiplies that f32 partial, and
the partials are summed in f32. The MoE kernels K6 ``w{8,4}_matmul_expert``
and K5 ``w{8,4}_matmul_pairs`` compute it on one expert of a stacked
weight, picked by int32 ids that stay on the device.
:func:`grouped_reference` is that arithmetic in plain torch;
:func:`launch` checks the tensors and calls a kernel through ctypes on
PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from vptq_tpu_torch.ops import _build

__all__ = ["check_pairs", "grouped_reference", "launch", "pick_expert"]

_OUT_CODES = {torch.bfloat16: 0, torch.float32: 1}


def grouped_reference(
    x: torch.Tensor,
    levels: torch.Tensor,
    scales: torch.Tensor,
    group: int,
    out_dtype: torch.dtype | None,
) -> torch.Tensor:
    """Plain version of K1–K4: levels (out, in_p) f32, scales (out, S) f32.

    Each group's f32 partial product of bf16-rounded x with the exact
    levels is multiplied by its scale; the partials are summed in f32,
    group by group, and the result cast to ``out_dtype`` (default
    ``x.dtype``).
    """
    out_f, in_p = levels.shape
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    xb = x.reshape(-1, in_p).to(torch.bfloat16).to(torch.float32)
    acc = None
    for g in range(in_p // group):
        cols = slice(g * group, (g + 1) * group)
        part = torch.matmul(xb[:, cols], levels[:, cols].t())
        part = part * scales[:, g][None, :]
        acc = part if acc is None else acc + part
    return acc.to(out_dtype).reshape(*lead, out_f)


def pick_expert(stacked: torch.Tensor, expert: torch.Tensor) -> torch.Tensor:
    """Slab ``expert`` (a one-element integer tensor) of a stacked array,
    gathered on its device: the plain versions' way to an expert. (An
    index with the tensor itself would read it on the host.)"""
    return stacked.index_select(0, expert.reshape(1).to(torch.int64))[0]


def check_pairs(x: torch.Tensor, experts: torch.Tensor) -> None:
    """A pairs launch takes x (P, in_p) and one expert id per row."""
    if x.dim() != 2 or experts.shape != x.shape[:1]:
        raise ValueError(
            f"x must be (P, in_p) with one expert id per row, got x "
            f"{tuple(x.shape)} and experts {tuple(experts.shape)}"
        )
    # pair p is blockIdx.y of the launch
    if x.shape[0] > 65535:
        raise ValueError(f"at most 65535 pairs in a launch, got {x.shape[0]}")


def launch(
    lib_name: str,
    fn_name: str,
    x: torch.Tensor,
    tensors: Sequence[torch.Tensor],
    ints: Sequence[int],
    out_f: int,
    in_p: int,
    out_dtype: torch.dtype | None,
    ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch ``fn_name`` of ``lib<lib_name>.so`` on CUDA tensors; raises
    on anything the kernel does not take, and on a failed launch.

    ``ids``: the int32 expert ids of a launch on stacked weights, passed
    to the kernel as a device pointer and never read on the host.
    """
    if x.device.type != "cuda":
        raise ValueError(f"{lib_name} runs on cuda or cpu, not {x.device}")
    if ids is not None:
        if ids.dtype != torch.int32 or not ids.is_contiguous():
            raise ValueError(f"{lib_name}: ids must be contiguous int32")
        tensors = (*tensors, ids)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{lib_name}: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{lib_name}: weights and scales must be contiguous")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _OUT_CODES:
        raise ValueError(f"unsupported output dtype {out_dtype}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, in_p).to(torch.bfloat16).contiguous()
    tokens = x2.shape[0]
    y = torch.empty(tokens, out_f, dtype=out_dtype, device=x.device)
    if tokens == 0:
        return y.reshape(*lead, out_f)
    # the kernels read x and every packed plane (all tensors but the
    # scales and the ids) with 16-byte loads
    planes = tensors[: -1 if ids is None else -2]
    if any(t.data_ptr() % 16 for t in (x2, *planes)):
        raise ValueError(f"{lib_name}: x and the weights must be 16-byte aligned")
    # int f(x, *tensors[, ids], y, T, out, in_p, *ints, out_dtype, stream)
    argtypes = (
        [ctypes.c_void_p] * (len(tensors) + 2)
        + [ctypes.c_int] * (4 + len(ints))
        + [ctypes.c_void_p],
        ctypes.c_int,
    )
    lib = _build.load(lib_name, {fn_name: argtypes})
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, fn_name)(
            x2.data_ptr(), *(t.data_ptr() for t in tensors), y.data_ptr(),
            tokens, out_f, in_p, *ints, _OUT_CODES[out_dtype], stream,
        )
    if err:
        raise RuntimeError(f"{lib_name} kernel launch failed: CUDA error {err}")
    return y.reshape(*lead, out_f)
