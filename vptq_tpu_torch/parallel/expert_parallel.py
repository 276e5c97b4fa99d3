"""Expert parallelism for the MoE blocks.

Port of ``vptq_tpu/parallel/expert_parallel.py``: the stacked experts of a
MoE block are split on the expert dim, each rank holding ``E / n`` whole
experts; every rank routes every token (the router is whole on each),
runs its own experts only, through the same kernels as one device (K5 for
few tokens, K6 for many), and one sum over the model axis combines the
partial outputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from vptq_tpu_torch.models.llama import (
    _MOE_FAST_MAX_TOKENS,
    StackedExperts,
    _moe_dense_mix,
    _moe_fast,
)
from vptq_tpu_torch.parallel.distributed import all_reduce

__all__ = ["moe_forward_ep", "moe_local", "shard_stacked_experts"]


def moe_local(
    stacked_local: StackedExperts,
    x: torch.Tensor,  # (..., hidden), the same on every rank of the axis
    top_ids: torch.Tensor,  # (..., k) int, global expert ids
    top_w: torch.Tensor,  # (..., k) f32
    num_experts: int,  # the global expert count
    tp,
) -> torch.Tensor:
    """One rank's share of the routed experts, summed over the axis: (...,
    hidden) f32.

    At most ``_MOE_FAST_MAX_TOKENS`` tokens: every (token, k) pair through
    the pairs kernel K5, the pairs whose expert another rank holds sent to
    local expert 0 with weight 0 (every rank runs the same pair count).
    More: every local expert on every token through K6, mixed by the
    routing weights of this rank's experts."""
    e_local = stacked_local.gate_up_wq.shape[0]
    lo = tp.rank * e_local
    n_tokens = x.numel() // x.shape[-1]
    if n_tokens <= _MOE_FAST_MAX_TOKENS:
        mine = (top_ids >= lo) & (top_ids < lo + e_local)
        ids = torch.where(mine, top_ids - lo, torch.zeros_like(top_ids))
        ws = torch.where(mine, top_w, torch.zeros_like(top_w))
        out = _moe_fast(stacked_local, x, ids, ws).to(torch.float32)
    else:
        mix = torch.zeros(
            (*top_ids.shape[:-1], num_experts), dtype=torch.float32,
            device=x.device,
        ).scatter_(-1, top_ids, top_w.to(torch.float32))
        out = _moe_dense_mix((), stacked_local, x,
                             mix[..., lo: lo + e_local])
    return all_reduce(out, tp)


def shard_stacked_experts(
    stacked: StackedExperts, mesh
) -> Optional[StackedExperts]:
    """This rank's experts of a whole stack, on its device; None when the
    expert count does not divide the model axis (the JAX package's
    answer, for a caller that keeps the stack whole)."""
    n, e = mesh.model, stacked.gate_up_wq.shape[0]
    if e % n:
        return None
    lo, hi = mesh.model_rank * (e // n), (mesh.model_rank + 1) * (e // n)

    def take(t):
        return t[lo:hi].to(mesh.device).clone()

    return StackedExperts(
        gate_up_wq=take(stacked.gate_up_wq),
        gate_up_scales=take(stacked.gate_up_scales),
        down_wq=take(stacked.down_wq),
        down_scales=take(stacked.down_scales),
        fmt=stacked.fmt,
    )


def moe_forward_ep(
    stacked_local: StackedExperts,
    x: torch.Tensor,
    top_ids: torch.Tensor,
    top_w: torch.Tensor,
    num_experts: int,
    mesh,
) -> torch.Tensor:
    """The routed experts over the mesh's model axis: :func:`moe_local` on
    this rank's stack (from :func:`shard_stacked_experts`)."""
    if num_experts % mesh.model:
        raise ValueError(
            f"experts {num_experts} must divide EP shards {mesh.model}"
        )
    return moe_local(stacked_local, x, top_ids.to(torch.int64), top_w,
                     num_experts, mesh.tp)
