"""P3: a GEMV whose weights are uint8 ids into a codebook of at most 256
vectors, expanded inside the kernel.

Port of the measurement kernel of ``examples/vq_smallk_probe.py:77``
(``vq_matmul``; body ``kernel`` at ``:92``). The kernel is hand-written
CUDA for Hopper in ``vptq_tpu_torch/csrc/vq_smallk_matmul.cu``: no
one-hot, the codebook is staged in shared memory, padded with zero rows
to 256. :func:`vq_smallk_matmul` launches it for CUDA tensors and runs
the plain version :func:`vq_smallk_matmul_reference` only for tensors
that lie on the CPU. No layer calls it; the examples and
``chip_smoke.py`` do.
"""

from __future__ import annotations

import torch

from vptq_tpu_torch.ops.scaled_matmul import launch

__all__ = ["VQ_SMALLK_VECTORS", "vq_smallk_matmul",
           "vq_smallk_matmul_reference", "vq_smallk_weight"]

VQ_SMALLK_VECTORS = (4, 8)  # vector lengths the kernel takes
MAX_CENTROIDS = 256


def _check(x: torch.Tensor, ids: torch.Tensor, codebook: torch.Tensor,
           v: int) -> int:
    """Validate shapes and dtypes; returns in_features."""
    if v not in VQ_SMALLK_VECTORS:
        raise ValueError(f"v must be one of {VQ_SMALLK_VECTORS}, got {v}")
    if ids.dtype != torch.uint8 or ids.dim() != 2:
        raise ValueError(f"ids must be 2-D uint8, got {ids.dtype} {tuple(ids.shape)}")
    in_f = ids.shape[1] * v
    if in_f % (16 * v):
        raise ValueError(f"in_features {in_f} must be a multiple of {16 * v}")
    k = codebook.shape[0]
    if (not codebook.is_floating_point() or codebook.dim() != 2
            or codebook.shape[1] != v or not 1 <= k <= MAX_CENTROIDS):
        raise ValueError(
            f"codebook must be float (k <= {MAX_CENTROIDS}, {v}), got "
            f"{codebook.dtype} {tuple(codebook.shape)}"
        )
    if not x.is_floating_point() or x.shape[-1] != in_f:
        raise ValueError(f"x must be floating point (..., {in_f})")
    return in_f


def vq_smallk_weight(ids: torch.Tensor, codebook: torch.Tensor
                     ) -> torch.Tensor:
    """(out, in) f32 weight: each id's bf16 codebook vector, zeros for an
    id >= k (the codebook padded with zero rows to 256)."""
    k, v = codebook.shape
    padded = torch.zeros(
        (MAX_CENTROIDS, v), dtype=torch.float32, device=codebook.device)
    padded[:k] = codebook.to(torch.bfloat16).to(torch.float32)
    return padded[ids.to(torch.int64)].reshape(ids.shape[0], -1)


def vq_smallk_matmul_reference(
    x: torch.Tensor,
    ids: torch.Tensor,
    codebook: torch.Tensor,
    v: int,
    onehot_only: bool = False,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain torch version: x and the codebook rounded to bf16, products
    summed in f32. ``onehot_only``: ``Σ_c x[t, c·v] · [ids[o, c] < k]``."""
    in_f = _check(x, ids, codebook, v)
    xb = x.reshape(-1, in_f).to(torch.bfloat16).to(torch.float32)
    if onehot_only:
        hit = (ids.to(torch.int64) < codebook.shape[0]).to(torch.float32)
        y = torch.matmul(xb[:, ::v], hit.t())
    else:
        y = torch.matmul(xb, vq_smallk_weight(ids, codebook).t())
    return y.to(out_dtype or x.dtype).reshape(*x.shape[:-1], ids.shape[0])


def vq_smallk_matmul(
    x: torch.Tensor,
    ids: torch.Tensor,
    codebook: torch.Tensor,
    v: int,
    onehot_only: bool = False,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x @ (codebook[ids] as (out, in))ᵀ`` through the P3 kernel; an id
    >= k adds 0.

    x (..., in) float; ids (out, in / v) uint8; codebook (k <= 256, v)
    float, rounded to bf16; v 4 or 8. Returns (..., out) in ``out_dtype``
    (default ``x.dtype``).
    """
    in_f = _check(x, ids, codebook, v)
    if x.device.type == "cpu":
        return vq_smallk_matmul_reference(
            x, ids, codebook, v, onehot_only, out_dtype)
    y = launch(
        "vq_smallk_matmul", "vptq_vq_smallk_matmul", x,
        (ids, codebook.to(torch.bfloat16).contiguous()),
        (codebook.shape[0], v, int(onehot_only)), ids.shape[0], in_f,
        out_dtype,
    )
    vq_smallk_matmul.launches += 1
    return y


vq_smallk_matmul.launches = 0
# the TPU kernel this one replaces (both variants)
vq_smallk_matmul.bodies = {
    "fused": "examples/vq_smallk_probe.py:92",
    "onehot_only": "examples/vq_smallk_probe.py:92",
}
vq_smallk_matmul.replaces = vq_smallk_matmul.bodies["fused"]
# the word of the demangled names of its CUDA kernels that picks them out
# of a trace
vq_smallk_matmul.trace_tags = ("vq_smallk_gemv",)
