"""Ring (context-parallel) attention over an axis of the mesh.

Port of ``vptq_tpu/parallel/ring.py``. The prompt's token chunks lie one
per rank of the axis (the data axis of ``parallel.tp.prefill_cp``); each
rank keeps its query chunk while the K/V chunks go round the ring, one
hop a step (``distributed.ppermute``): n - 1 chunk-sized transfers
instead of an S × S attention on one rank. Causality fixes the
schedule: step 0 is the rank's own (diagonal) chunk under a causal mask,
and after ``s`` hops a rank holds the chunk ``s`` places before its own,
which it sees whole when ``s <= `` its index and discards otherwise (the
untwisted ring).

The partial states merge by the online softmax of flash attention: each
block gives its normalized output with each row's max and sum of
exponentials, and two states combine exactly. Plain torch in f32, as the
JAX package's is plain ``jnp``: no TPU kernel stands behind it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vptq_tpu_torch.parallel.distributed import ppermute

__all__ = ["chunk_attention", "ring_attention"]

_NEG = -1e30


def chunk_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, Dv)
    causal: bool,
    sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One q chunk against one k/v chunk, with the flash residuals.

    Returns ``(o, l, m)``: the softmax-normalized output over this k/v
    range, and each query row's sum of exponentials ``l`` and max ``m``
    (the state two blocks merge by). GQA: the q heads H are a multiple of
    the kv heads KV, head ``h`` reading kv head ``h // (H / KV)``."""
    b, sq, nh, d = q.shape
    nkv = k.shape[2]
    group = nh // nkv
    qg = q.reshape(b, sq, nkv, group, d)
    scores = torch.einsum(
        "bqkgd,btkd->bkgqt", qg.to(torch.float32), k.to(torch.float32)
    ) * sm_scale  # (B, KV, G, Sq, Sk)
    if causal:
        t = torch.arange(k.shape[1], device=q.device)
        mask = t[None, :] <= torch.arange(sq, device=q.device)[:, None]
        scores = torch.where(mask, scores, _NEG)
    m = scores.amax(dim=-1)  # (B, KV, G, Sq)
    p = torch.exp(scores - m[..., None])
    li = p.sum(dim=-1)
    o = torch.einsum(
        "bkgqt,btkd->bkgqd", p, v.to(torch.float32)
    ) / li.clamp(min=1e-38)[..., None]
    # back to (B, Sq, H, Dv) / (B, Sq, H)
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, nh, v.shape[3])
    li = li.permute(0, 3, 1, 2).reshape(b, sq, nh)
    m = m.permute(0, 3, 1, 2).reshape(b, sq, nh)
    return o, li, m


def _merge(o_a, l_a, m_a, o_b, l_b, m_b):
    """Combine two normalized partial-softmax states exactly."""
    m_new = torch.maximum(m_a, m_b)
    wa = torch.exp(m_a - m_new) * l_a
    wb = torch.exp(m_b - m_new) * l_b
    l_new = wa + wb
    o_new = (
        o_a * wa[..., None] + o_b * wb[..., None]
    ) / l_new.clamp(min=1e-38)[..., None]
    return o_new, l_new, m_new


def ring_attention(
    q: torch.Tensor,  # (B, Sc, H, D): this rank's sequence chunk
    k: torch.Tensor,  # (B, Sc, KV, D)
    v: torch.Tensor,  # (B, Sc, KV, Dv)
    axis,  # the ring (a mesh.TPAxis): rank i holds [i*Sc, (i+1)*Sc)
    sm_scale: float,
) -> torch.Tensor:
    """Causal self-attention with the sequence split over ``axis``.

    Every rank of the axis calls it with its chunk. Step 0 is the local
    chunk under a causal mask; each further step passes the K/V chunks
    one hop round the ring, and a chunk from later in the sequence (more
    hops than this rank's index) enters the merge as an empty state, as
    the JAX package masks it. Returns (B, Sc, H, Dv) in q's dtype."""
    n, my = axis.size, axis.rank
    o, l, m = chunk_attention(q, k, v, True, sm_scale)
    kv = (k, v)
    perm = [(i, (i + 1) % n) for i in range(n)]
    for s in range(1, n):
        kv = ppermute(kv, axis, perm)
        if s <= my:
            oi, li, mi = chunk_attention(q, *kv, False, sm_scale)
        else:
            # JAX computes the block and selects zeros: the same state
            li = torch.zeros_like(l)
            mi = torch.full_like(m, _NEG)
            oi = torch.zeros_like(o)
        o, l, m = _merge(o, l, m, oi, li, mi)
    return o.to(q.dtype)
