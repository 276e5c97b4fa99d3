"""Llama decoder stack (dense Llama 2/3, Mistral, Qwen2 and Mixtral MoE),
in torch.

Port of the dense-Llama and Mixtral parts of ``vptq_tpu/models/llama.py``:
RMSNorm, RoPE (default and llama3 scaling), GQA attention over a
per-layer KV cache (a fresh bf16 prefill of 1024 tokens or more, at a
head size it is built for, through the flash-attention kernel K8;
Mistral's sliding window in the masks), SwiGLU,
with every projection a runtime linear (Qwen2's q/k/v carry a bias), and
the sparse MoE block (f32 router, top-k, softmax over the top-k) whose
stacked int8 / int4 experts run through the expert kernels K6 (every
expert on every token, for more than 64 tokens) or the pairs kernels K5
(the selected experts only, in decode). Modules hold the weights;
:func:`forward` is the function the JAX package jits. There is no
autograd on this path.

The KV cache is updated in place (JAX's is functional). Its lengths
live on the device, one per sequence, and :func:`forward` advances them
in place, so a decode step captured as a CUDA graph reads and writes
them at a fixed address. Every shape that depends on them (the live
cache prefix, the number of 256-position decode blocks) follows from
the longest length, which the caller knows on the host (the prompt
length and the steps taken) and never reads back from the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vptq_tpu_torch.ops.flash_attention import flash_attention, kernel_takes
from vptq_tpu_torch.ops.w4_matmul_expert import w4_matmul_expert
from vptq_tpu_torch.ops.w4_matmul_pairs import w4_matmul_pairs
from vptq_tpu_torch.ops.w8_matmul_expert import w8_matmul_expert
from vptq_tpu_torch.ops.w8_matmul_pairs import w8_matmul_pairs

__all__ = [
    "Attention",
    "Block",
    "KVCache",
    "Mlp",
    "Model",
    "ModelConfig",
    "MoeMlp",
    "StackedExperts",
    "attended",
    "forward",
    "init_cache",
    "takes_flash",
]

# a fresh prefill this long (and no sliding window) takes the
# flash-attention kernel K8, as in the JAX package on a TPU, when K8 is
# built for its dtype and head size; shorter chunks, chunks at an offset
# and the rest take _cache_and_attend
_FLASH_MIN_SEQ = 1024
_DECODE_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture config, parsed from HF ``config.json``.

    The dense-Llama, Mistral, Qwen2 and Mixtral fields of the JAX
    package's config, plus the ones that mark a family the port does not
    run yet (DeepSeek's MoE, MLA), so the loader can refuse such a
    checkpoint.
    """

    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[Tuple[Tuple[str, Any], ...]] = None
    tie_word_embeddings: bool = False
    model_type: str = "llama"
    max_position_embeddings: int = 4096
    attention_bias: bool = False
    num_local_experts: int = 0
    num_experts_per_tok: int = 0
    n_routed_experts: int = 0
    kv_lora_rank: int = 0
    sliding_window: Optional[int] = None

    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        heads = d["num_attention_heads"]
        rope_scaling = d.get("rope_scaling")
        if rope_scaling is not None:
            rope_scaling = tuple(sorted(rope_scaling.items()))
        return cls(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_hidden_layers=d["num_hidden_layers"],
            num_attention_heads=heads,
            num_key_value_heads=d.get("num_key_value_heads", heads),
            head_dim=d.get("head_dim", d["hidden_size"] // heads),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            rope_theta=d.get("rope_theta", 10000.0),
            rope_scaling=rope_scaling,
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            model_type=d.get("model_type", "llama"),
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            attention_bias=d.get("attention_bias", d.get("qkv_bias", False)),
            num_local_experts=d.get("num_local_experts", 0),
            num_experts_per_tok=d.get("num_experts_per_tok", 0),
            n_routed_experts=d.get("n_routed_experts") or 0,
            kv_lora_rank=d.get("kv_lora_rank") or 0,
            sliding_window=(
                d.get("sliding_window")
                if d.get("use_sliding_window", True)
                else None
            ),
        )

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0


# --------------------------------------------------------------------
# RoPE and norm
# --------------------------------------------------------------------


def rope_frequencies(
    cfg: ModelConfig, device
) -> Tuple[torch.Tensor, float]:
    """(per-pair inverse frequencies (f32), cos/sin scaling).

    Default and llama3 scaling, with the semantics of HF transformers'
    ROPE_INIT_FUNCTIONS.
    """
    dim = cfg.head_dim
    exponents = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    inv_freq = 1.0 / (cfg.rope_theta ** (exponents / dim))
    scaling = dict(cfg.rope_scaling) if cfg.rope_scaling else None
    kind = scaling.get("rope_type", scaling.get("type")) if scaling else None
    if kind == "llama3":
        factor = scaling["factor"]
        low_factor = scaling["low_freq_factor"]
        high_factor = scaling["high_freq_factor"]
        old_len = scaling["original_max_position_embeddings"]
        low_wavelen = old_len / low_factor
        high_wavelen = old_len / high_factor
        wavelen = 2 * math.pi / inv_freq
        smooth = (old_len / wavelen - low_factor) / (high_factor - low_factor)
        inv_freq = torch.where(
            wavelen > low_wavelen,
            inv_freq / factor,
            torch.where(
                wavelen < high_wavelen,
                inv_freq,
                (1 - smooth) * inv_freq / factor + smooth * inv_freq,
            ),
        )
    elif kind not in (None, "default"):
        raise NotImplementedError(f"rope scaling {kind!r} is not ported yet")
    return inv_freq, 1.0


def rope_cos_sin(
    positions: torch.Tensor,  # (B, S) int
    inv_freq: torch.Tensor,  # (D/2,)
    scale: float = 1.0,
):
    """cos/sin tables (B, S, 1, D/2), computed once per forward."""
    angles = positions[..., None].to(torch.float32) * inv_freq
    return (
        (torch.cos(angles) * scale)[:, :, None, :],
        (torch.sin(angles) * scale)[:, :, None, :],
    )


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """Rotary embedding, half-split pairing (HF rotate_half semantics)."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float
) -> torch.Tensor:
    xf = x.to(torch.float32)
    norm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (norm * weight.to(torch.float32)).to(x.dtype)


# --------------------------------------------------------------------
# Modules
# --------------------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, q_proj, k_proj, v_proj, o_proj, qkv_proj=None):
        super().__init__()
        # fused q|k|v (one matmul, split after); when set, q/k/v are None
        self.q_proj, self.k_proj, self.v_proj = q_proj, k_proj, v_proj
        self.o_proj = o_proj
        self.qkv_proj = qkv_proj


class Mlp(nn.Module):
    def __init__(self, gate_proj, up_proj, down_proj, gate_up_proj=None):
        super().__init__()
        self.gate_proj, self.up_proj = gate_proj, up_proj
        self.down_proj = down_proj
        self.gate_up_proj = gate_up_proj


class StackedExperts(nn.Module):
    """The experts of one MoE block stacked along a leading expert dim,
    in the int8 or the int4 runtime layout.

    Built by ``layers/runtime.py:stack_experts`` when every expert is a
    fused gate|up + down pair of one family. Both MoE paths read these
    arrays through kernels that pick an expert's slab by an id on the
    device (K6 ``w{8,4}_matmul_expert``, K5 ``w{8,4}_matmul_pairs``), so
    the weights exist once.
    """

    def __init__(
        self,
        # int8: wq (E, out, in_p) int8, scales (E, in_p / group, out) f32;
        # int4: wq (E, out, in_p / 2) nibbles, scales (E, in_p / 128, out)
        # bf16; gate_up has out = 2*inter, down has out = hidden
        gate_up_wq: torch.Tensor,
        gate_up_scales: torch.Tensor,
        down_wq: torch.Tensor,
        down_scales: torch.Tensor,
        fmt: str = "int8",
    ):
        super().__init__()
        if fmt not in ("int8", "int4"):
            raise ValueError(f"experts stack in int8 or int4, not {fmt!r}")
        self.register_buffer("gate_up_wq", gate_up_wq)
        self.register_buffer("gate_up_scales", gate_up_scales)
        self.register_buffer("down_wq", down_wq)
        self.register_buffer("down_scales", down_scales)
        self.fmt = fmt
        # the id each K6 launch reads, made once: a new tensor per launch
        # would be a host-to-device copy per expert and layer
        self.register_buffer(
            "expert_ids",
            torch.arange(
                gate_up_wq.shape[0], dtype=torch.int32,
                device=gate_up_wq.device,
            ),
            persistent=False,
        )


class MoeMlp(nn.Module):
    """Mixtral-style sparse MoE block: softmax router + top-k experts.

    More than 64 tokens (every prefill bucket) evaluate every expert on
    every token, mixed by a routing weight that is zero outside the
    top-k; fewer (decode) take the selected-experts path when ``stacked``
    is present. ``experts`` is empty then: ``fuse_block`` drops the
    per-expert copies, and both paths read the stacked arrays.
    """

    def __init__(
        self, router, experts, num_experts_per_tok: int = 2, stacked=None
    ):
        super().__init__()
        self.router = router  # hidden -> num_experts
        self.experts = nn.ModuleList(experts)
        self.num_experts_per_tok = num_experts_per_tok
        self.stacked = stacked


class Block(nn.Module):
    def __init__(self, input_layernorm, attn, post_attention_layernorm, mlp):
        super().__init__()
        self.register_buffer("input_layernorm", input_layernorm)
        self.attn = attn
        self.register_buffer(
            "post_attention_layernorm", post_attention_layernorm
        )
        self.mlp = mlp


class Model(nn.Module):
    def __init__(self, embed_tokens, blocks, norm, lm_head, cfg: ModelConfig):
        super().__init__()
        self.register_buffer("embed_tokens", embed_tokens)  # (vocab, hidden)
        self.blocks = nn.ModuleList(blocks)
        self.register_buffer("norm", norm)
        self.lm_head = lm_head  # None => tied to embed_tokens
        self.cfg = cfg
        # depends only on cfg: computed once, not in every forward
        inv_freq, self.rope_scale = rope_frequencies(cfg, embed_tokens.device)
        self.register_buffer("inv_freq", inv_freq, persistent=False)


@dataclasses.dataclass
class KVCache:
    """Preallocated per-layer K/V buffers, updated in place.

    ``lengths`` (B,) int64 on the cache's device: the tokens cached per
    sequence, advanced in place (its address stays fixed). ``max_len`` is
    the largest of them as the host knows it: whoever sets the lengths
    sets it too, and :func:`forward` advances both.
    """

    k: List[torch.Tensor]  # per layer: (B, max_seq, kv_heads, hd)
    v: List[torch.Tensor]
    lengths: torch.Tensor
    max_len: int = 0

    def reset(self, length: int) -> None:
        """Every sequence to ``length`` tokens, written on the device by a
        fill (no host-to-device copy)."""
        self.lengths.fill_(length)
        self.max_len = length


def init_cache(
    cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype, device
) -> KVCache:
    shape = (batch, max_seq, cfg.num_key_value_heads, cfg.head_dim)
    layers = range(cfg.num_hidden_layers)
    return KVCache(
        k=[torch.zeros(shape, dtype=dtype, device=device) for _ in layers],
        v=[torch.zeros(shape, dtype=dtype, device=device) for _ in layers],
        lengths=torch.zeros(batch, dtype=torch.int64, device=device),
    )


# --------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------


def _attention(
    block_idx: int,
    attn: Attention,
    x: torch.Tensor,  # (B, S, hidden)
    cos: torch.Tensor,
    sin: torch.Tensor,
    cache: KVCache,
    offsets: torch.Tensor,  # (B,) int64 on x.device: cache.lengths
    cfg: ModelConfig,
    live: int,  # cache positions read, from attended()
    fresh_prefill: bool = False,
) -> torch.Tensor:
    batch, seq, _ = x.shape
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    hd = cfg.head_dim
    if attn.qkv_proj is not None:
        q, k, v = torch.split(
            attn.qkv_proj(x), [nh * hd, nkv * hd, nkv * hd], dim=-1
        )
    else:
        q, k, v = attn.q_proj(x), attn.k_proj(x), attn.v_proj(x)
    q = apply_rope(q.reshape(batch, seq, nh, hd), cos, sin)
    k = apply_rope(k.reshape(batch, seq, nkv, hd), cos, sin)
    v = v.reshape(batch, seq, nkv, hd)
    if fresh_prefill and takes_flash(cfg, seq, q.dtype):
        # fused causal attention over the fresh chunk only (offset 0), in
        # the activation dtype; v stays a view into the fused q|k|v row
        _insert_kv(block_idx, k, v, cache)
        out = flash_attention(q, k, v, hd ** -0.5)
    else:
        out = _cache_and_attend(
            block_idx, q, k, v, cache, offsets, cfg, live, scale=hd ** -0.5
        )
    return attn.o_proj(out.to(x.dtype))


def takes_flash(cfg: ModelConfig, seq: int, dtype: torch.dtype) -> bool:
    """Whether a fresh chunk of ``seq`` tokens in ``dtype`` goes through
    K8: long enough, no sliding window, and a dtype and head size the
    kernel is built for. It depends on no device: a model takes one route
    on the CPU and on the card."""
    return (
        seq >= _FLASH_MIN_SEQ
        and cfg.sliding_window is None
        and kernel_takes(dtype, cfg.head_dim)
    )


def takes_blocks(max_seq: int) -> bool:
    """Whether one token attends a cache of ``max_seq`` positions block by
    block (:func:`_decode_attend_blocks`): whole 256-position blocks."""
    return max_seq >= _DECODE_BLOCK and max_seq % _DECODE_BLOCK == 0


def attended(max_len: int, seq: int, max_seq: int) -> int:
    """The cache positions a call of ``seq`` tokens reads, from the longest
    cached length before it (a host integer). One token on a cache of
    whole blocks reads the live 256-position blocks, ``(max_len + 256) //
    256`` of them (the trip count of the JAX package's ``while_loop``,
    whose offsets are the lengths before the call); any other call reads
    the live prefix. Every shape of a call follows from it, so the eager
    step and a CUDA graph captured at the same count run the same ops."""
    if seq == 1 and takes_blocks(max_seq):
        return (max_len + _DECODE_BLOCK) // _DECODE_BLOCK * _DECODE_BLOCK
    return min(max_len + seq, max_seq)


def _decode_attend_blocks(
    q: torch.Tensor,  # (B, 1, H, Dk)
    k_cache: torch.Tensor,  # (B, T, KV, Dk)
    v_cache: torch.Tensor,  # (B, T, KV, Dv)
    offsets: torch.Tensor,  # (B,) new token already inserted at offsets[b]
    cfg: ModelConfig,
    scale: float,
    live: int,  # host: the live blocks' positions, from attended()
    block: int = _DECODE_BLOCK,
) -> torch.Tensor:
    """Single-token attention over only the live 256-position blocks.

    Each block gets its own online-softmax statistics (max, sum,
    weighted values), and the blocks are combined by rescaling to the
    common max: the flash-decoding structure of the JAX package's
    ``lax.while_loop``, with the block count given by the caller from
    what the host knows (no device read). Cache traffic scales with the
    live length, not the allocated ``max_seq``.
    """
    batch, _, nh, dk = q.shape
    nkv, dv = k_cache.shape[2], v_cache.shape[3]
    group = nh // nkv
    n_blocks = live // block
    qf = q[:, 0].to(torch.float32).reshape(batch, nkv, group, dk)
    kb = k_cache[:, :live].to(torch.float32).reshape(
        batch, n_blocks, block, nkv, dk
    )
    vb = v_cache[:, :live].to(torch.float32).reshape(
        batch, n_blocks, block, nkv, dv
    )
    # scores (B, KV, G, n_blocks, block)
    sc = torch.einsum("bkgd,bntkd->bkgnt", qf, kb) * scale
    t_ids = torch.arange(live, device=q.device).reshape(n_blocks, block)
    valid = t_ids[None] <= offsets[:, None, None]
    if cfg.sliding_window is not None:
        valid = valid & (
            t_ids[None] > offsets[:, None, None] - cfg.sliding_window
        )
    valid = valid[:, None, None]
    sc = sc.masked_fill(~valid, -math.inf)
    m_blk = sc.amax(dim=-1)
    # guard fully-masked blocks (their max stays -inf)
    m_safe = torch.where(torch.isfinite(m_blk), m_blk, 0.0)
    p = torch.exp(sc - m_safe[..., None]).masked_fill(~valid, 0.0)
    s_blk = p.sum(dim=-1)
    acc_blk = torch.einsum("bkgnt,bntkd->bkgnd", p, vb)
    m = m_blk.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    corr = torch.where(
        torch.isfinite(m_blk), torch.exp(m_blk - m), torch.zeros_like(m_blk)
    )
    s = (s_blk * corr).sum(dim=-1)
    acc = (acc_blk * corr[..., None]).sum(dim=-2)
    out = acc / (s[..., None] + 1e-30)
    return out.reshape(batch, 1, nh * dv)


def _rows(pos: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B, S) positions as a gather / scatter index over the rows of a
    (B, T, heads, dim) tensor."""
    return pos[:, :, None, None].expand(-1, -1, t.shape[2], t.shape[3])


def _insert_kv(
    block_idx: int, k: torch.Tensor, v: torch.Tensor, cache: KVCache
):
    """Write new K/V rows at each sequence's offset, in place, with the
    offsets read on the device.

    One token: one batched scatter at ``(b, lengths[b])``, as the JAX
    package does. A chunk: each sequence writes an S-row window, moved
    back where it would pass ``max_seq``; its rows before ``lengths[b]``
    write back what they hold, so the chunk's rows past ``max_seq`` are
    dropped (the JAX package scatters with ``mode="drop"``) and no index
    leaves the cache (one past the end would trip a device assert on
    CUDA).
    """
    k_cache, v_cache = cache.k[block_idx], cache.v[block_idx]
    seq, max_seq = k.shape[1], k_cache.shape[1]
    if seq > max_seq:
        raise ValueError(f"a chunk of {seq} tokens exceeds max_seq {max_seq}")
    lengths = cache.lengths
    for new, buf in ((k, k_cache), (v, v_cache)):
        new = new.to(buf.dtype)
        if seq == 1:
            buf.scatter_(1, _rows(lengths[:, None], buf), new)
            continue
        pos = (torch.clamp(lengths, max=max_seq - seq)[:, None]
               + torch.arange(seq, device=buf.device))
        src = pos - lengths[:, None]  # the chunk's row; < 0: keep the cache's
        rows = torch.where(
            (src < 0)[:, :, None, None],
            buf.gather(1, _rows(pos, buf)),
            new.gather(1, _rows(src.clamp(min=0), new)),
        )
        buf.scatter_(1, _rows(pos, buf), rows)


def _cache_and_attend(
    block_idx: int,
    q: torch.Tensor,  # (B, S, H, Dk)
    k: torch.Tensor,  # (B, S, KV, Dk)
    v: torch.Tensor,  # (B, S, KV, Dv)
    cache: KVCache,
    offsets: torch.Tensor,
    cfg: ModelConfig,
    live: int,
    scale: float,
) -> torch.Tensor:
    """Insert k/v at each sequence's offset and run masked attention over
    the ``live`` cache positions (:func:`attended`, from the host)."""
    batch, seq, nh, dk = q.shape
    nkv, dv = k.shape[2], v.shape[3]
    _insert_kv(block_idx, k, v, cache)
    k_cache, v_cache = cache.k[block_idx], cache.v[block_idx]
    if seq == 1 and takes_blocks(k_cache.shape[1]):
        return _decode_attend_blocks(
            q, k_cache, v_cache, offsets, cfg, scale, live
        )
    group = nh // nkv
    # only the live prefix: later positions are masked for every query
    qg = q.reshape(batch, seq, nkv, group, dk).permute(0, 2, 3, 1, 4)
    scores = torch.einsum(
        "bkgsd,btkd->bkgst",
        qg.to(torch.float32),
        k_cache[:, :live].to(torch.float32),
    ) * scale
    t_ids = torch.arange(live, device=q.device)
    q_pos = offsets[:, None] + torch.arange(seq, device=q.device)[None, :]
    mask = t_ids[None, None, :] <= q_pos[:, :, None]  # (B, S, T)
    if cfg.sliding_window is not None:
        mask = mask & (
            t_ids[None, None, :] > q_pos[:, :, None] - cfg.sliding_window
        )
    scores = scores.masked_fill(~mask[:, None, None], -math.inf)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bkgst,btkd->bkgsd", probs, v_cache[:, :live].to(torch.float32)
    )
    return out.permute(0, 3, 1, 2, 4).reshape(batch, seq, nh * dv)


# The selected-experts path runs when a call holds at most this many
# tokens: each token reads k experts' bytes, so a batch whose n·k nears E
# is better served by the all-experts path, which reads each expert once.
_MOE_FAST_MAX_TOKENS = 64

_EXPERT_MATMUL = {"int8": w8_matmul_expert, "int4": w4_matmul_expert}
_PAIRS_MATMUL = {"int8": w8_matmul_pairs, "int4": w4_matmul_pairs}


def _padded_in(wq: torch.Tensor, fmt: str) -> int:
    return wq.shape[2] * (2 if fmt == "int4" else 1)


def _pad_rows(x2: torch.Tensor, in_p: int) -> torch.Tensor:
    if x2.shape[-1] != in_p:
        x2 = F.pad(x2, (0, in_p - x2.shape[-1]))
    return x2


def _expert_matmul(x2, wq, scales, e, fmt="int8"):
    """(T, in) rows through expert ``e`` (a one-element int32 tensor on
    the device) of stacked (E, out, in[/2]) weights: K6. The JAX package
    chunks T at 512 for its kernel's VMEM; rows are independent, and the
    kernels here take any T."""
    return _EXPERT_MATMUL[fmt](
        _pad_rows(x2, _padded_in(wq, fmt)), wq, scales, e
    )


def _pairs_matmul(x_pairs, wq, scales, experts, fmt="int8"):
    """(P, in) rows through their per-row experts of a stacked weight, one
    launch for all (token, top-k) pairs of a MoE step: K5."""
    return _PAIRS_MATMUL[fmt](
        _pad_rows(x_pairs, _padded_in(wq, fmt)), wq, scales, experts
    )


def _moe_fast(
    stacked: StackedExperts,
    x: torch.Tensor,  # (..., hidden)
    top_ids: torch.Tensor,  # (..., k) int
    top_w: torch.Tensor,  # (..., k) f32
) -> torch.Tensor:
    """The selected experts only: all n·k (token, expert) pairs through
    two launches (gate_up, down), each pair reading its expert's bytes."""
    lead, hidden = x.shape[:-1], x.shape[-1]
    k = top_ids.shape[-1]
    xf = x.reshape(-1, hidden)
    n = xf.shape[0]
    ids = top_ids.reshape(n * k).to(torch.int32)
    x_pairs = xf.repeat_interleave(k, dim=0)  # (n*k, hidden)
    gu = _pairs_matmul(
        x_pairs, stacked.gate_up_wq, stacked.gate_up_scales, ids, stacked.fmt
    )
    gate, up = gu.chunk(2, dim=-1)
    down = _pairs_matmul(
        F.silu(gate) * up, stacked.down_wq, stacked.down_scales, ids,
        stacked.fmt,
    )  # (n*k, hidden)
    out = torch.sum(
        down.reshape(n, k, hidden).to(torch.float32)
        * top_w.reshape(n, k, 1).to(torch.float32),
        dim=1,
    )
    return out.reshape(*lead, hidden).to(x.dtype)


def _stacked_expert_mlp(stacked: StackedExperts, x2, e: int):
    """Expert ``e``'s SwiGLU MLP on (T, hidden) rows from the stacked
    weights (the all-experts path)."""
    eid = stacked.expert_ids[e]
    gu = _expert_matmul(
        x2, stacked.gate_up_wq, stacked.gate_up_scales, eid, stacked.fmt
    )
    gate, up = gu.chunk(2, dim=-1)
    return _expert_matmul(
        F.silu(gate) * up, stacked.down_wq, stacked.down_scales, eid,
        stacked.fmt,
    )


def _moe_dense_mix(moe_experts, stacked, x, mix):
    """Every expert on every token, mixed in f32 by (..., E) routing
    weights, summed in expert order. Per-expert modules when present
    (formats that do not stack), else the stacked arrays."""
    if len(moe_experts):
        out = torch.zeros_like(x, dtype=torch.float32)
        for e, expert in enumerate(moe_experts):
            out = out + mix[..., e: e + 1] * _mlp(expert, x).to(torch.float32)
        return out
    lead, hidden = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, hidden)
    mix2 = mix.reshape(-1, mix.shape[-1]).to(torch.float32)
    out = torch.zeros(
        (x2.shape[0], hidden), dtype=torch.float32, device=x.device
    )
    for e in range(stacked.gate_up_wq.shape[0]):
        d = _stacked_expert_mlp(stacked, x2, e)[:, :hidden]
        out = out + mix2[:, e: e + 1] * d.to(torch.float32)
    return out.reshape(*lead, hidden)


def _route_moe(
    x: torch.Tensor,  # (..., hidden)
    top_ids: torch.Tensor,  # (..., k) int
    top_w: torch.Tensor,  # (..., k) f32
    num_experts: int,
    experts,
    stacked: Optional[StackedExperts],
) -> torch.Tensor:
    """Send routed tokens to experts: the selected-experts path for few
    tokens, every expert otherwise."""
    n_tokens = x.numel() // x.shape[-1]
    if stacked is not None and n_tokens <= _MOE_FAST_MAX_TOKENS:
        return _moe_fast(stacked, x, top_ids, top_w)
    # scatter the normalized weights back to a dense (..., E) mix (the
    # top-k ids of a token are distinct)
    mix = torch.zeros(
        (*top_ids.shape[:-1], num_experts), dtype=torch.float32,
        device=x.device,
    ).scatter_(-1, top_ids, top_w.to(torch.float32))
    return _moe_dense_mix(experts, stacked, x, mix).to(x.dtype)


def _top_k(logits: torch.Tensor, k: int):
    """The k largest logits and their ids, ties to the lower id as
    ``jax.lax.top_k`` resolves them (``torch.topk`` promises no order,
    and in bf16 the router's logits tie often: another expert would be
    another model)."""
    order = torch.sort(logits, dim=-1, descending=True, stable=True)
    return order.values[..., :k], order.indices[..., :k]


def _moe_mlp(moe: MoeMlp, x: torch.Tensor) -> torch.Tensor:
    # router in f32 (HF MixtralSparseMoeBlock does the same)
    logits = moe.router(x).to(torch.float32)  # (..., E)
    top_w, top_ids = _top_k(logits, moe.num_experts_per_tok)
    top_w = torch.softmax(top_w, dim=-1)  # normalize over the top-k
    return _route_moe(
        x, top_ids, top_w, logits.shape[-1], moe.experts, moe.stacked
    )


def _mlp(mlp, x: torch.Tensor) -> torch.Tensor:
    if isinstance(mlp, MoeMlp):
        return _moe_mlp(mlp, x)
    if mlp.gate_up_proj is not None:
        gate, up = mlp.gate_up_proj(x).chunk(2, dim=-1)
    else:
        gate, up = mlp.gate_proj(x), mlp.up_proj(x)
    return mlp.down_proj(F.silu(gate) * up)


def forward(
    model: Model,
    tokens: torch.Tensor,  # (B, S) int
    cache: KVCache,
    dtype=torch.bfloat16,
    fresh_prefill: bool = False,
) -> Tuple[torch.Tensor, KVCache]:
    """Run the decoder over ``tokens`` starting at ``cache.lengths``.

    Returns (logits (B, S, vocab) f32, cache); the cache is updated in
    place and its lengths advanced by S on the device (``max_len`` on the
    host). Nothing is read back from the device.
    """
    cfg = model.cfg
    batch, seq = tokens.shape
    device = model.embed_tokens.device
    ids = tokens.to(device=device, dtype=torch.int64)
    x = model.embed_tokens[ids].to(dtype)
    offsets = cache.lengths
    positions = offsets[:, None] + torch.arange(seq, device=device)[None, :]
    cos, sin = rope_cos_sin(positions, model.inv_freq, model.rope_scale)
    live = attended(cache.max_len, seq, cache.k[0].shape[1])

    for i, block in enumerate(model.blocks):
        h = rms_norm(x, block.input_layernorm, cfg.rms_norm_eps)
        x = x + _attention(
            i, block.attn, h, cos, sin, cache, offsets, cfg, live,
            fresh_prefill=fresh_prefill,
        )
        h = rms_norm(x, block.post_attention_layernorm, cfg.rms_norm_eps)
        x = x + _mlp(block.mlp, h)

    x = rms_norm(x, model.norm, cfg.rms_norm_eps)
    if model.lm_head is not None:
        logits = model.lm_head(x)
    else:
        logits = torch.matmul(
            x.to(torch.float32), model.embed_tokens.to(torch.float32).t()
        )
    cache.lengths.add_(seq)
    cache.max_len += seq
    return logits.to(torch.float32), cache
