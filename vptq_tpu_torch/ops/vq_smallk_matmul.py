"""P3: a GEMV whose weights are uint8 ids into a codebook of at most 256
vectors, expanded inside the kernel.

Port of the measurement kernel of ``examples/vq_smallk_probe.py:77``
(``vq_matmul``; body ``kernel`` at ``:92``). The kernel is hand-written
CUDA for Hopper in ``vptq_tpu_torch/csrc/vq_smallk_matmul.cu`` on the
asynchronous ring of ``csrc/ring_gemv.cuh``: no one-hot, the ids stream
through a ``cp.async`` ring, the codebook is staged in shared memory as a
table padded with zero rows to 256, and the products run on tensor cores
(``mma.sync``). :func:`vq_smallk_matmul` launches it for CUDA tensors,
with the token tile and cluster size that :func:`vq_smallk_plan` plans,
and runs the plain version :func:`vq_smallk_matmul_reference` only for
tensors that lie on the CPU. No layer calls it; the examples and
``chip_smoke.py`` do.
"""

from __future__ import annotations

import torch

from vptq_tpu_torch.ops.scaled_matmul import (
    launch, ring_plan, sm_count,
)

__all__ = ["VQ_SMALLK_VECTORS", "vq_smallk_matmul",
           "vq_smallk_matmul_reference", "vq_smallk_plan", "vq_smallk_smem",
           "vq_smallk_weight"]

VQ_SMALLK_VECTORS = (4, 8)  # vector lengths the kernel takes
MAX_CENTROIDS = 256
# the kernel's block (csrc/vq_smallk_matmul.cu): 64 rows, a ring of four
# stages of 128 ids a row, the codebook table of 256 rows of 128 bytes
# (fused), x as 8-byte units, a chunk of 16 ids 16 of them at v 4, 32 at v
# 8, 4 onehot (the first position of four ids a unit), each chunk's
# followed by 2 spare units and each token's row skewed by 1 unit (v 8: 2)
VQ_ROWS = 64
VQ_STAGE = 128
_HEAD = 256 + 4 * VQ_ROWS * VQ_STAGE
_TABLE = MAX_CENTROIDS * 128


def vq_smallk_smem(v: int, onehot_only: bool, tokens: int,
                   stages: int) -> int:
    """Shared memory of one block of the kernel whose range is ``stages``
    stages (bytes): its ring, the table (fused), x for ``tokens`` rows and
    the partials the cluster's ranks push (one f32 a row and token)."""
    chunk, skew = (4, 1) if onehot_only else (4 * v, v // 4)
    pitch = -(-stages * 8 * (chunk + 2) // 16) * 16 + skew  # units a row
    return (_HEAD + (0 if onehot_only else _TABLE)
            + tokens * pitch * 8 + VQ_ROWS * tokens * 4)


def vq_smallk_plan(out_f: int, in_f: int, tokens: int, v: int,
                   onehot_only: bool, n_sm: int) -> tuple:
    """(token tile, cluster size) a launch passes the kernel (``ring_plan``
    over a row's stages of 128 ids); the size is 0 where no split fits x
    into a block."""
    return ring_plan(
        out_f, -(-(in_f // v) // VQ_STAGE), tokens, n_sm,
        lambda t, s: vq_smallk_smem(v, onehot_only, t, s), lambda _: VQ_ROWS)


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
    tokens = x.numel() // in_f
    tile, split = vq_smallk_plan(ids.shape[0], in_f, max(tokens, 1), v,
                                 onehot_only, sm_count(x.device))
    if not split:
        raise ValueError(
            f"vq_smallk_matmul: in_features {in_f} is too wide for the "
            "kernel's shared memory")
    # the kernel loads each centroid whole (16 bytes at v 8)
    cb = codebook.to(torch.bfloat16).contiguous()
    if cb.data_ptr() % 16:
        cb = cb.clone()
    y = launch(
        "vq_smallk_matmul", "vptq_vq_smallk_matmul", x, (ids, cb),
        (codebook.shape[0], v, int(onehot_only), split, tile), ids.shape[0],
        in_f,
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
vq_smallk_matmul.trace_tags = ("vq_smallk", "ring_gemv")
