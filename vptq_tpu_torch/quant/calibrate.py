"""Calibration-driven model re-encode: GPTQ + mixed precision.

Port of ``vptq_tpu/quant/calibrate.py``. Walks the decoder block by block
(the GPTQ protocol), on the model's device:

  1. run the block's forward on calibration activations with per-linear
     input recorders (``H += x^T x`` per quantization site, f32 on the
     device),
  2. quantize the block's linears with error feedback against H
     (:func:`vptq_tpu_torch.quant.gptq.gptq_quantize`),
  3. under ``int8_threshold``, re-encode a site whose measured relative
     output error exceeds it as int8; under ``int8_fraction``, the sites a
     ranking pass found most sensitive go int8; the mixed int2 / int3
     formats instead give each site's most energetic input columns an int8
     side matrix,
  4. run the block again with the QUANTIZED weights, through their
     kernels, so later blocks calibrate against the activations they will
     see.

The capture step replaces each compressed linear with an exact f32 dense
mirror and wraps one member of each shared-input site with a recorder,
so every model forward goes through the existing ``models/llama.py``
code (GQA, MLA, MoE) with no model-specific capture code. Activations
and the attention cache are f32, and every product is true f32
(``gptq.true_f32``).

MoE: the all-experts path feeds every token to every expert, so expert
Hessians are unweighted by routing probability (it mis-weights only the
second moments' importance, not their values).
"""

from __future__ import annotations

import copy
import json
import logging
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vptq_tpu_torch.layers.dense import DenseLinear
from vptq_tpu_torch.layers.runtime import (
    INT2_MIXED_COL_FRACTION,
    INT3_MIXED_COL_FRACTION,
    Int2MixedLinear,
    Int3MixedLinear,
    _blocked,
    _exact_weight,
    blocked_pad,
    concat_blocked,
    fuse_model,
    int2_from_q,
    int3_from_q,
    int4_from_q,
    int8_from_q,
    pick_group,
)
from vptq_tpu_torch.layers.vqlinear import VQLinear
from vptq_tpu_torch.models.llama import (
    DeepseekMoe,
    MlaAttention,
    Model,
    MoeMlp,
    _attention,
    _mla_attention,
    _mlp,
    attended,
    init_cache,
    rms_norm,
    rope_cos_sin,
)
from vptq_tpu_torch.models.loader import _read_safetensors, write_safetensors
from vptq_tpu_torch.quant.gptq import (
    dequant_groups,
    gptq_quantize,
    group_spans,
    output_error_ratio,
    true_f32,
)
from vptq_tpu_torch.tools.export_runtime import _flatten_block, _Reader

logger = logging.getLogger("vptq_tpu_torch")

__all__ = [
    "quantize_model_calibrated",
    "synthetic_calibration_tokens",
]

# the int8 site budget of "int4-mixed" (its ranking pass): the 3/8 of the
# sites of highest measured sensitivity go int8 (~5.5 bits a weight)
MIXED_INT8_FRACTION = 0.375

_FORMATS = (
    "int4", "int4-mixed", "int3", "int3-mixed", "int2", "int2-mixed", "int8",
)


def synthetic_calibration_tokens(
    vocab_size: int,
    n_tokens: int = 4096,
    seq_len: int = 512,
    seed: int = 0,
) -> torch.Tensor:
    """(B, S) int32 random-token calibration batch (CPU), the JAX
    package's ids for the same arguments. For use when no text corpus is
    at hand; accuracy numbers want real tokenized text."""
    rng = np.random.default_rng(seed)
    seq_len = min(seq_len, n_tokens)
    batch = max(1, n_tokens // seq_len)
    return torch.from_numpy(rng.integers(
        0, vocab_size, (batch, seq_len), dtype=np.int64
    ).astype(np.int32))


class _Hess:
    """Running input second moment of one quantization site, f32 on the
    device of its inputs.

    ``diag_only`` accumulates just the per-column sum of squares (the
    ranking pass reads only the diagonal): an (in,) buffer instead of
    (in, in).
    """

    # token chunk of the rank-k accumulation: bounds the (chunk, in) f32
    # copy of the inputs
    CHUNK = 8192

    def __init__(self, n: int, device, diag_only: bool = False):
        self.h = None if diag_only else torch.zeros(
            (n, n), dtype=torch.float32, device=device)
        self.d = torch.zeros(
            n, dtype=torch.float32, device=device) if diag_only else None
        self.count = 0

    def update(self, x: torch.Tensor) -> None:
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        with true_f32():
            for c0 in range(0, x2.shape[0], self.CHUNK):
                xc = x2[c0: c0 + self.CHUNK]
                if self.d is not None:
                    self.d += (xc * xc).sum(dim=0)
                else:
                    self.h.addmm_(xc.t(), xc)
        self.count += x2.shape[0]

    @property
    def diag(self) -> torch.Tensor:
        return self.d if self.d is not None else torch.diagonal(self.h)


class _Rec(nn.Module):
    """A linear that records its input, then runs (a module, so that it
    takes a linear's slot in the block)."""

    def __init__(self, lin: nn.Module, hess: Optional[_Hess]):
        super().__init__()
        self.lin = lin
        self.hess = hess

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.hess is not None:
            self.hess.update(x)
        return self.lin(x)


def _set(block: nn.Module, path: str, value: nn.Module) -> None:
    parent, _, name = path.rpartition(".")
    setattr(block.get_submodule(parent) if parent else block, name, value)


def _exists(block: nn.Module, path: str) -> bool:
    try:
        block.get_submodule(path)
    except AttributeError:  # absent, or None
        return False
    return True


def _vq_members(block: nn.Module, paths) -> List[Tuple[str, VQLinear]]:
    """(path, layer) of the compressed linears among ``paths``."""
    out = []
    for p in paths:
        lin = block.get_submodule(p)
        if isinstance(lin, VQLinear):
            out.append((p, lin))
    return out


def _tree_copy(module: nn.Module) -> nn.Module:
    """The module tree copied over the same tensors: replacing a layer of
    the copy leaves the original as it was."""
    new = copy.copy(module)
    new._modules = {
        name: None if m is None else _tree_copy(m)
        for name, m in module._modules.items()
    }
    new._buffers = dict(module._buffers)
    new._parameters = dict(module._parameters)
    return new


def _mlp_slots(prefix: str, mlp, site_prefix: str):
    """(path, site) slots of an Mlp, fused or split."""
    slots = []
    if getattr(mlp, "gate_up_proj", None) is not None:
        slots.append((f"{prefix}.gate_up_proj", f"{site_prefix}gate_up"))
    else:
        slots.append((f"{prefix}.gate_proj", f"{site_prefix}gate_up"))
        slots.append((f"{prefix}.up_proj", f"{site_prefix}gate_up"))
    slots.append((f"{prefix}.down_proj", f"{site_prefix}down"))
    return slots


def _block_slots(block) -> List[Tuple[str, str]]:
    """(dotted path, site) of one block's linears. Slots of one site share
    their input (q|k|v, gate|up; MLA's q or q_a with kv_a): one Hessian
    and one joint format decision, so fusion stays possible."""
    slots: List[Tuple[str, str]] = []
    attn = block.attn
    if isinstance(attn, MlaAttention):
        if attn.q_proj is not None:
            slots.append(("attn.q_proj", "attn_in"))
        else:
            slots.append(("attn.q_a_proj", "attn_in"))
            slots.append(("attn.q_b_proj", "q_b"))
        slots.append(("attn.kv_a_proj", "attn_in"))
        slots.append(("attn.o_proj", "o"))
    else:
        if attn.qkv_proj is not None:
            slots.append(("attn.qkv_proj", "qkv"))
        else:
            slots.append(("attn.q_proj", "qkv"))
            slots.append(("attn.k_proj", "qkv"))
            slots.append(("attn.v_proj", "qkv"))
        slots.append(("attn.o_proj", "o"))

    mlp = block.mlp
    if isinstance(mlp, (MoeMlp, DeepseekMoe)):
        for e in range(len(mlp.experts)):
            slots.extend(
                _mlp_slots(f"mlp.experts.{e}", mlp.experts[e], f"e{e}.")
            )
        if isinstance(mlp, DeepseekMoe):
            slots.extend(
                _mlp_slots("mlp.shared_experts", mlp.shared_experts,
                           "shared.")
            )
    else:
        slots.extend(_mlp_slots("mlp", mlp, ""))
    return [(p, s) for p, s in slots if _exists(block, p)]


def _site_map(block) -> Dict[str, List[str]]:
    """Slot paths grouped into shared-input sites, in slot order."""
    sites: Dict[str, List[str]] = {}
    for path, site in _block_slots(block):
        sites.setdefault(site, []).append(path)
    return sites


def _block_forward(i, block, x, cos, sin, cache, cfg) -> torch.Tensor:
    """One decoder block on a fresh prefill: the loop body of
    ``models.llama.forward`` (the cache's lengths stay 0)."""
    offsets = cache.lengths
    live = attended(cache.max_len, x.shape[1], cache.k[0].shape[1])
    h = rms_norm(x, block.input_layernorm, cfg.rms_norm_eps)
    if isinstance(block.attn, MlaAttention):
        x = x + _mla_attention(
            i, block.attn, h, cos, sin, cache, offsets, cfg, live
        )
    else:
        x = x + _attention(
            i, block.attn, h, cos, sin, cache, offsets, cfg, live,
            fresh_prefill=True,
        )
    h = rms_norm(x, block.post_attention_layernorm, cfg.rms_norm_eps)
    return x + _mlp(block.mlp, h)


def _rtn_sensitivity(
    w: torch.Tensor, diag_h: torch.Tensor, bits: int = 4
) -> float:
    """Diag-Hessian-weighted relative output error of the plain base-bits
    RTN re-encode: the ranking pass's per-layer sensitivity, O(out·in)."""
    group = 64 if bits == 2 else 128
    q, s = gptq_quantize(w, None, bits=bits, group=group)
    spans = group_spans(w.shape[1], group)
    dw = dequant_groups(q, s, spans, 0.5 if bits == 2 else 0.0) - w
    d = diag_h.to(torch.float64)
    num = float((dw.to(torch.float64) ** 2).sum(dim=0) @ d)
    den = float((w.to(torch.float64) ** 2).sum(dim=0) @ d)
    return num / den if den > 0 else 0.0


def _pad_hessian(hess: torch.Tensor, n: int) -> torch.Tensor:
    """``hess`` in the top-left corner of an (n, n) zero matrix."""
    hp = hess.new_zeros((n, n))
    k = hess.shape[0]
    hp[:k, :k] = hess
    return hp


def _gptq_layer(bits, w, bias, hess, damp, steps=None):
    """GPTQ-encode one weight matrix; returns (layer, w_hat)."""
    in_f = w.shape[1]
    if bits in (3, 4):
        group = 128
    elif bits == 2:
        group = 64
    else:
        group = pick_group(in_f)
    pad = (-in_f) % group
    wp = nn.functional.pad(w, (0, pad)) if pad else w
    hp = hess
    if hess is not None and pad:
        hp = _pad_hessian(hess, in_f + pad)
    q, scales = gptq_quantize(wp, hp, bits=bits, group=group, damp=damp,
                              steps=steps)
    del hp
    spans = group_spans(wp.shape[1], group)
    w_hat = dequant_groups(q, scales, spans, 0.5 if bits == 2 else 0.0)
    from_q = {2: int2_from_q, 3: int3_from_q, 4: int4_from_q,
              8: int8_from_q}[bits]
    return from_q(q, scales, bias), w_hat[:, :in_f]


def _gptq_layer_blocked(bits, w, bias, hess, damp, shards, steps=None):
    """GPTQ-encode one weight matrix in the blocked layout of tensor
    parallelism; returns (layer, w_hat).

    The in axis is zero-padded to a multiple of ``shards`` and cut into
    that many contiguous column shards; each gets its own GPTQ pass
    against the matching diagonal block of H (the shards quantize apart,
    so no error feeds back across a shard), padded as the blocked RTN
    encoders pad it, so that ``tp_place_block(reencode_rows=False)``
    slices the calibrated codes as they are. ``w_hat`` is the shards'
    dequantized weights side by side, cut to the logical width. The
    layer carries ``shards``: it is a placement artifact, which computes
    its product only shard by shard (``parallel/tp.py`` ``ShardSum``)."""
    n = w.shape[1]
    pad = (-n) % shards
    wp = nn.functional.pad(w, (0, pad)) if pad else w
    hp = hess
    if hess is not None and pad:
        hp = _pad_hessian(hess, n + pad)
    blk = wp.shape[1] // shards
    group, shard_pad = blocked_pad(bits, blk)
    from_q = {2: int2_from_q, 3: int3_from_q, 4: int4_from_q}.get(bits)
    parts, hats = [], []
    for s in range(shards):
        ws = wp[:, s * blk: (s + 1) * blk]
        hs = None if hp is None else hp[s * blk: (s + 1) * blk,
                                        s * blk: (s + 1) * blk]
        spad = (-blk) % shard_pad
        if spad:
            ws = nn.functional.pad(ws, (0, spad))
            if hs is not None:
                hs = _pad_hessian(hs, blk + spad)
        q, scales = gptq_quantize(ws.contiguous(), None if hs is None
                                  else hs.contiguous(), bits=bits,
                                  group=group, damp=damp, steps=steps)
        hats.append(dequant_groups(
            q, scales, group_spans(ws.shape[1], group),
            0.5 if bits == 2 else 0.0)[:, :blk])
        parts.append(int8_from_q(q, scales) if from_q is None
                     else from_q(q, scales, pad_to=shard_pad))
    return concat_blocked(parts, shards, bias), torch.cat(hats, dim=1)[:, :n]


def _select_cols(
    weights: List[torch.Tensor],
    hess: Optional[torch.Tensor],
    col_frac: float,
    shards: int = 1,
) -> torch.Tensor:
    """The most sensitive input COLUMNS of one site, joint over its
    members (so q|k|v share one selection and stay fusable), in order.

    A column's sensitivity is ``diag(H)[c] * sum_r w[r, c]^2``, the
    first-order output energy it carries, in f64; the top ones are taken
    by numpy's argsort on the host, as the JAX package takes them, so
    ties fall the same way. The count, per contiguous column shard of
    ``shards`` (one for a site that is not row-parallel under tensor
    parallelism), is ``col_frac`` of the shard's columns, at least 128
    and a multiple of 128 (a kernel-shaped int8 side), at most the
    shard's largest multiple of 128; a shard narrower than 128 gives
    every column. Every shard gives the same count, so each rank's side
    has one shape. Returns global column ids, shard by shard.
    """
    in_f = weights[0].shape[1]
    col_e = torch.zeros(in_f, dtype=torch.float64, device=weights[0].device)
    for w in weights:
        col_e += (w.to(torch.float64) ** 2).sum(dim=0)
    if hess is not None:
        col_e *= torch.diagonal(hess).to(torch.float64)[:in_f]
    if in_f % shards:
        raise ValueError(
            f"in_features {in_f} does not divide {shards} TP shards")
    blk = in_f // shards
    k = max(128, int(round(blk * col_frac)))
    k = ((k + 127) // 128) * 128
    if blk < 128:
        k = blk
    else:
        k = min(k, blk - blk % 128 if blk % 128 else blk)
    e = col_e.cpu().numpy()
    cols = np.concatenate([
        s * blk + np.sort(np.argsort(e[s * blk: (s + 1) * blk])[::-1][:k])
        for s in range(shards)
    ])
    return torch.from_numpy(cols.astype(np.int64)).to(col_e.device)


def _gptq_layer_mixed(base_bits, w, bias, hess, damp, cols, steps=None,
                      shards=1):
    """Column-block mixed encode: int8 on ``cols``, int3 / int2 planes
    elsewhere.

    The selected columns are zeroed (weights and Hessian rows / columns)
    for the base pass, where they are dead inputs. The int8 side then
    carries the RESIDUAL ``w[:, cols] - w_hat[:, cols]``: int3 planes
    dequant the zeroed positions to 0 exactly, but the int2 half-offset
    grid dequants them to ±0.5·s, and the residual absorbs that, which
    keeps ``y = base(x) + int8(x[cols])``.

    ``shards > 1`` (a row-parallel site under tensor parallelism):
    ``cols`` holds one count per contiguous column shard
    (:func:`_select_cols`); the base encodes blocked
    (:func:`_gptq_layer_blocked`), the side shard by shard (its scale
    groups never straddle a shard), and ``col_idx`` holds SHARD-LOCAL
    ids, which index each rank's slice of x: a placement artifact like
    the blocked planes.
    """
    wb = w.clone()
    wb[:, cols] = 0.0
    hb = hess
    if hess is not None:
        hb = hess.clone()
        hb[cols, :] = 0.0
        hb[:, cols] = 0.0
    if shards > 1:
        lin_b, w_hat = _gptq_layer_blocked(base_bits, wb, None, hb, damp,
                                           shards, steps)
    else:
        lin_b, w_hat = _gptq_layer(base_bits, wb, None, hb, damp, steps)
    del wb, hb

    # the side at group 128, shard by shard: real widths select a
    # multiple of 128, toy widths below 128 zero-pad their one group
    k = cols.numel() // shards
    q8s, s8s, hat8s = [], [], []
    for s in range(shards):
        cs = cols[s * k: (s + 1) * k]
        w8 = w[:, cs] - w_hat[:, cs]
        h8 = None if hess is None else hess[cs][:, cs]
        pad = (-k) % 128
        if pad:
            w8 = nn.functional.pad(w8, (0, pad))
            if h8 is not None:
                h8 = _pad_hessian(h8, k + pad)
        q8, s8 = gptq_quantize(w8, h8, bits=8, group=128, damp=damp,
                               steps=steps)
        q8s.append(q8)
        s8s.append(s8)
        hat8s.append(
            dequant_groups(q8, s8, group_spans(w8.shape[1], 128))[:, :k])
    lin8 = int8_from_q(torch.cat(q8s, dim=1), torch.cat(s8s, dim=1), None)
    w_hat[:, cols] = w_hat[:, cols] + torch.cat(hat8s, dim=1)
    col_idx = cols
    if shards > 1:
        # each rank's slice of col_idx indexes its own block of x
        col_idx = cols - torch.arange(
            shards, device=cols.device).repeat_interleave(k) * (
                w.shape[1] // shards)
    cls = Int2MixedLinear if base_bits == 2 else Int3MixedLinear
    lin = cls(lin_b, lin8, col_idx.to(torch.int32), bias)
    return (_blocked(lin, shards) if shards > 1 else lin), w_hat


def _quantize_site(
    members: List[Tuple[str, VQLinear]],
    hess: Optional[torch.Tensor],
    fmt: str,
    int8_threshold: Optional[float],
    damp: float,
    force_int8: bool = False,
    col_frac: Optional[float] = None,
    steps: Optional[dict] = None,
    row_shards: int = 1,
):
    """GPTQ-encode the linears of one site; returns
    ([(path, new layer)], site report). ``steps``: GPTQ's group steps,
    kept across calls (``gptq_quantize``). ``row_shards > 1``: the
    blocked layout of tensor parallelism, GPTQ shard by shard."""
    weights = [(p, _exact_weight(lin), lin.bias) for p, lin in members]

    # the H-weighted error ratio costs an (out, in) x (in, in) product per
    # member; it decides only on the threshold path, so the report
    # otherwise gets the O(out·in) weight-RMS ratio
    err_hess = hess if int8_threshold is not None else None

    if col_frac is not None:
        # column-block mixed int3 / int2: one joint selection per site
        base_bits = 2 if fmt == "int2-mixed" else 3
        cols = _select_cols([w for _p, w, _b in weights], hess, col_frac,
                            shards=row_shards)
        out, errs = [], []
        for path, w, bias in weights:
            lin, w_hat = _gptq_layer_mixed(base_bits, w, bias, hess, damp,
                                           cols, steps, shards=row_shards)
            errs.append(output_error_ratio(w, w_hat, err_hess))
            out.append((path, lin))
        return out, {
            "format": fmt,
            "err_ratio": max(errs),
            "int8_cols": int(cols.numel()),
        }

    def encode(bits: int):
        out, errs = [], []
        for path, w, bias in weights:
            if row_shards > 1:
                lin, w_hat = _gptq_layer_blocked(bits, w, bias, hess, damp,
                                                 row_shards, steps)
            else:
                lin, w_hat = _gptq_layer(bits, w, bias, hess, damp, steps)
            errs.append(output_error_ratio(w, w_hat, err_hess))
            out.append((path, lin))
        return out, errs

    base_bits = {
        "int8": 8, "int3": 3, "int3-mixed": 3, "int2": 2, "int2-mixed": 2,
    }.get(fmt, 4)
    target_bits = 8 if force_int8 else base_bits
    encoded, errs = encode(target_bits)
    site_fmt = f"int{target_bits}"
    err_base = max(errs) if target_bits != 8 else None
    if (target_bits != 8 and int8_threshold is not None
            and err_base > int8_threshold):
        encoded, errs = encode(8)
        site_fmt = "int8"
    rep = {"format": site_fmt, "err_ratio": max(errs)}
    if err_base is not None:
        rep[f"err_ratio_int{base_bits}"] = err_base
    return encoded, rep


def _capture_block(
    i, block, sites, x, cos, sin, cache, cfg, diag_only: bool = False
) -> Tuple[torch.Tensor, Dict[str, _Hess]]:
    """Run one block with exact f32 dense mirrors of its compressed
    linears and one input recorder per site that has a compressed member.
    Returns (x_next, hessians)."""
    hessians: Dict[str, _Hess] = {}
    cap = _tree_copy(block)
    for site, paths in sites.items():
        vq = _vq_members(block, paths)
        rec_h = None
        if vq:
            rec_h = hessians[site] = _Hess(vq[0][1].in_features, x.device,
                                           diag_only)
        for j, p in enumerate(paths):
            lin = block.get_submodule(p)
            if isinstance(lin, VQLinear):
                lin = DenseLinear(weight=_exact_weight(lin), bias=lin.bias)
            _set(cap, p, _Rec(lin, rec_h if j == 0 else None))
    return _block_forward(i, cap, x, cos, sin, cache, cfg), hessians


def _fresh_inputs(model: Model, ids: torch.Tensor):
    """(x, cos, sin, cache) of a fresh prefill of ``ids`` (B, S): the f32
    embeddings, the rope tables at positions 0..S-1 and an f32 cache of
    S + 8 positions."""
    batch, seq = ids.shape
    device = ids.device
    x = model.embed_tokens[ids].to(torch.float32)
    positions = torch.arange(seq, device=device)[None, :].expand(batch, seq)
    cos, sin = rope_cos_sin(positions, model.inv_freq, model.rope_scale)
    cache = init_cache(model.cfg, batch, seq + 8, torch.float32, device)
    return x, cos, sin, cache


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Resume:
    """A calibration's progress in ``root``: ``manifest.json`` (phase,
    next block, the ranking's sensitivities, the shard count of the
    blocked layout), the carried activations (``state.safetensors``) and
    each finished block (``block_NNNN.safetensors`` under the runtime
    checkpoint's names, its report in ``block_NNNN.json``). Every file is
    written whole to a temporary name and moved into place, the manifest
    last, so a run killed at any point leaves a manifest whose files are
    complete. A run resumed with another ``tp_shards`` raises: its
    finished blocks are in another layout."""

    def __init__(self, root, cfg, device, tp_shards: int = 1):
        self.root, self.cfg, self.device = Path(root), cfg, device
        self.tp_shards = tp_shards
        self.root.mkdir(parents=True, exist_ok=True)
        self.manifest = {"phase": "rank", "next_block": 0, "sens": {}}
        path = self.root / "manifest.json"
        if path.exists():
            with open(path) as f:
                self.manifest = json.load(f)
            was = self.manifest.get("tp_shards", 1)
            if was != tp_shards:
                raise ValueError(
                    f"{root} holds a calibration at tp_shards={was}; "
                    f"resuming it at tp_shards={tp_shards} would mix two "
                    "layouts (start again in another directory)"
                )
            logger.info("resuming calibration: phase=%s block=%d",
                        self.manifest["phase"], self.manifest["next_block"])

    def _write_json(self, obj, name: str) -> None:
        tmp = self.root / f"{name}.tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, self.root / name)

    def save(self, phase: str, next_block: int, x: torch.Tensor,
             sens: dict) -> None:
        write_safetensors({"x": x}, self.root / "state.safetensors")
        self._write_json(
            {"phase": phase, "next_block": next_block, "sens": sens,
             "tp_shards": self.tp_shards},
            "manifest.json",
        )

    def load_x(self) -> torch.Tensor:
        return _read_safetensors(
            self.root / "state.safetensors")["x"].to(self.device)

    def save_block(self, i: int, block, rep: dict) -> None:
        write_safetensors(_flatten_block({}, f"blocks.{i}", block),
                          self.root / f"block_{i:04d}.safetensors")
        self._write_json(rep, f"block_{i:04d}.json")

    def load_block(self, i: int):
        raw = _read_safetensors(self.root / f"block_{i:04d}.safetensors")
        block = _Reader(raw, self.cfg, self.device,
                        shards=self.tp_shards).block(f"blocks.{i}")
        with open(self.root / f"block_{i:04d}.json") as f:
            return block, json.load(f)


# the sites whose linears are row-parallel under tensor parallelism (the
# in axis sharded, parallel/tp.py): the attention output and the dense
# and shared-expert down projections. Routed experts' down projections
# ("e{k}.down") are placed whole by expert parallelism and stay unblocked.
_ROW_PARALLEL_SITES = ("o", "down", "shared.down")


def quantize_model_calibrated(
    model: Model,
    tokens=None,
    fmt: str = "int4",
    *,
    int8_threshold: Optional[float] = None,
    int8_fraction: Optional[float] = None,
    damp: float = 0.01,
    fuse: bool = True,
    tp_shards: int = 1,
    resume_dir: Optional[str] = None,
    site_workers: int = 2,
    on_block: Optional[Callable[[int, nn.Module], None]] = None,
) -> Tuple[Model, Dict[str, dict]]:
    """Calibrated re-encode of a codebook-format model, on its device.

    Args:
        model: a :class:`~vptq_tpu_torch.models.llama.Model` loaded with
            ``runtime_format="codebook"`` and ``fuse=False`` (exact); it
            is left as it was.
        tokens: (B, S) calibration token ids (tensor or array); default
            4096 synthetic tokens (:func:`synthetic_calibration_tokens`).
        fmt: "int4" / "int3" / "int2" / "int8" (pure GPTQ), "int4-mixed"
            (GPTQ plus int8 for the most sensitive sites), "int3-mixed" /
            "int2-mixed" (GPTQ planes plus an int8 side on each site's
            most energetic columns).
        int8_threshold: measured output-error ratio above which a site is
            re-encoded int8 (site-level formats only).
        int8_fraction: for site-level formats, keep this fraction of
            sites int8, chosen by a ranking pass (diag-H-weighted RTN
            sensitivity over the whole model, then a quantile cut;
            default ``MIXED_INT8_FRACTION`` for "int4-mixed" when neither
            knob is given); for "int3-mixed" / "int2-mixed", the fraction
            of columns on the int8 side.
        fuse: fuse q|k|v and gate|up and stack the experts afterwards
            (``runtime.fuse_model``).
        tp_shards: above 1, the row-parallel sites (``o``, ``down``,
            ``shared.down``) encode in the blocked layout of tensor
            parallelism over that many shards, GPTQ shard by shard
            (:func:`_gptq_layer_blocked`), so that ``tp_place_block(
            reencode_rows=False)`` places the calibrated codes as they are.
            The activations carried to the next block are what the placed
            model computes: each blocked layer runs as the sum over its
            shards of each shard's layer on its slice of x
            (``parallel/tp.py`` ``shards_summed``). Here the port departs
            from the JAX package on purpose: its blocked calibration
            carries them through the blocked layers as if they were
            one-device layers (``vptq_tpu/quant/calibrate.py:1016-1020``),
            which they are not, so its Hessians from block 1 on come from
            wrong activations (ROADMAP Queue 3, "Recorded"). Block 0 is
            the same in both.
        resume_dir: checkpoint each finished block and the carried
            activations there; a run started again with the same
            directory (and ``tp_shards``) resumes at the first unfinished
            block.
        site_workers: accepted for the JAX package's signature; on one
            device the sites of a block encode one after another, and the
            result does not depend on it.
        on_block: called as ``on_block(i, block)`` with each finished,
            still unfused block in order (a resumed run's saved blocks
            too): the loader hands each block to the other ranks of a
            mesh as soon as it is done.

    Returns:
        (the quantized Model, a per-site report with an extra "summary"
        entry: site counts per format, calibration tokens, seconds in
        all and per stage: ranking, capture, GPTQ, propagation, and per
        block of the main pass).
    """
    from vptq_tpu_torch.parallel.tp import shards_summed

    del site_workers
    if fmt not in _FORMATS:
        raise ValueError(f"unsupported calibrated format {fmt!r}")
    col_frac = None
    if fmt in ("int3-mixed", "int2-mixed"):
        if int8_threshold is not None:
            raise ValueError(
                f"int8_threshold is a site-level knob; {fmt} mixes per "
                "column — pass int8_fraction (the column fraction) instead"
            )
        col_frac = int8_fraction if int8_fraction is not None else (
            INT2_MIXED_COL_FRACTION if fmt == "int2-mixed"
            else INT3_MIXED_COL_FRACTION
        )
        int8_fraction = None  # no site-level ranking pass
    elif (fmt == "int4-mixed" and int8_threshold is None
          and int8_fraction is None):
        int8_fraction = MIXED_INT8_FRACTION

    cfg = model.cfg
    device = model.embed_tokens.device
    if tokens is None:
        tokens = synthetic_calibration_tokens(cfg.vocab_size)
    ids = torch.as_tensor(np.asarray(tokens)).to(device=device,
                                                 dtype=torch.int64)
    batch, seq = ids.shape
    blocks = list(model.blocks)

    report: Dict[str, dict] = {}
    stats = dict(rank_s=0.0, capture_s=0.0, gptq_s=0.0, propagate_s=0.0)
    block_s: List[float] = []
    t_start = time.perf_counter()

    def clock(key: str, t0: float) -> float:
        _sync(device)
        t = time.perf_counter()
        stats[key] += t - t0
        return t

    # with resume_dir: only x is carried between blocks, as capture runs
    # fresh-prefill attention and never reads an earlier layer's cache
    resume = None if resume_dir is None else _Resume(resume_dir, cfg, device,
                                                     tp_shards)
    manifest = resume.manifest if resume else {"phase": "rank", "sens": {}}

    # GPTQ's group steps, kept for the whole run: one recorded column
    # loop per shape on the card (gptq.py)
    steps: dict = {}
    with true_f32():
        # ---- ranking pass: measured per-site sensitivity -> int8 set
        forced_int8: set = set()
        if int8_fraction is not None and fmt != "int8":
            x, cos, sin, cache = _fresh_inputs(model, ids)
            sens: Dict[str, float] = dict(manifest.get("sens", {}))
            rank_start = 0
            if resume is not None:
                rank_start = (manifest["next_block"]
                              if manifest["phase"] == "rank" else len(blocks))
                if manifest["phase"] == "rank" and rank_start > 0:
                    x = resume.load_x()
            bits = {"int3": 3, "int2": 2}.get(fmt.split("-")[0], 4)
            for i, block in enumerate(blocks):
                if i < rank_start:
                    continue
                t0 = time.perf_counter()
                sites = _site_map(block)
                x, hessians = _capture_block(
                    i, block, sites, x, cos, sin, cache, cfg, diag_only=True
                )
                for site, h in hessians.items():
                    sens[f"layers.{i}.{site}"] = max(
                        _rtn_sensitivity(_exact_weight(lin), h.diag, bits=bits)
                        for _, lin in _vq_members(block, sites[site])
                    )
                del hessians
                clock("rank_s", t0)
                logger.info("ranking pass block %d/%d", i + 1, len(blocks))
                if resume is not None:
                    resume.save("rank", i + 1, x, sens)
            # the main phase's checkpoints carry the ranking on: a resumed
            # run rebuilds the int8 set from it
            manifest["sens"] = dict(sens)
            n8 = int(round(len(sens) * int8_fraction))
            ranked = sorted(sens, key=sens.get, reverse=True)
            forced_int8 = set(ranked[:n8])
            for k, v in sens.items():
                report[k] = {"sensitivity": v}
            logger.info(
                "ranking pass: %d/%d sites -> int8 (cut %.3g)",
                n8, len(sens), sens[ranked[n8 - 1]] if n8 else 0.0,
            )

        # ---- main pass: capture + GPTQ + propagate the quantized stream
        x, cos, sin, cache = _fresh_inputs(model, ids)
        new_blocks = []
        main_start = 0
        if resume is not None and manifest["phase"] == "main":
            main_start = manifest["next_block"]
            if main_start > 0:
                x = resume.load_x()
                for bi in range(main_start):
                    qb, rep_b = resume.load_block(bi)
                    new_blocks.append(qb)
                    for k, v in rep_b.items():
                        report.setdefault(k, {}).update(v)
                    if on_block is not None:
                        on_block(bi, qb)
        for i, block in enumerate(blocks):
            if i < main_start:
                continue
            t_blk = t0 = time.perf_counter()
            sites = _site_map(block)
            x_cap, hessians = _capture_block(
                i, block, sites, x, cos, sin, cache, cfg
            )
            t0 = clock("capture_s", t0)
            qblock = _tree_copy(block)
            rep_block: Dict[str, dict] = {}
            for site, paths in sites.items():
                members = _vq_members(block, paths)
                if not members:
                    continue
                key = f"layers.{i}.{site}"
                h = hessians[site]
                encoded, site_rep = _quantize_site(
                    members, h.h if h.count else None, fmt, int8_threshold,
                    damp, force_int8=key in forced_int8, col_frac=col_frac,
                    steps=steps,
                    row_shards=(tp_shards if site in _ROW_PARALLEL_SITES
                                else 1),
                )
                for path, new_lin in encoded:
                    _set(qblock, path, new_lin)
                report.setdefault(key, {}).update(site_rep)
                rep_block.setdefault(key, {}).update(site_rep)
            del hessians
            t0 = clock("gptq_s", t0)
            if rep_block:
                # propagate the QUANTIZED activations to later blocks, as
                # the placed model computes them (blocked layers shard by
                # shard, summed)
                x = _block_forward(i, shards_summed(qblock), x, cos, sin,
                                   cache, cfg)
            else:
                x = x_cap
            del x_cap
            clock("propagate_s", t0)
            new_blocks.append(qblock)
            if resume is not None:
                resume.save_block(i, qblock, rep_block)
                resume.save("main", i + 1, x, manifest.get("sens", {}))
            if on_block is not None:
                on_block(i, qblock)
            block_s.append(time.perf_counter() - t_blk)
            logger.info(
                "calibrated block %d/%d (%.1fs): %s", i + 1, len(blocks),
                block_s[-1],
                {k.split(".")[-1]: v["format"] for k, v in rep_block.items()},
            )
        del x, cache, steps  # the recorded graphs' memory too

    out = Model(
        embed_tokens=model.embed_tokens, blocks=new_blocks, norm=model.norm,
        lm_head=model.lm_head, cfg=cfg,
    )
    if fuse:
        fuse_model(out)

    counts: Dict[str, int] = {}
    for r in report.values():
        f = r.get("format")
        if f:
            counts[f] = counts.get(f, 0) + 1
    report["summary"] = {
        "sites": sum(counts.values()),
        "int2_sites": counts.get("int2", 0),
        "int2_mixed_sites": counts.get("int2-mixed", 0),
        "int3_sites": counts.get("int3", 0),
        "int3_mixed_sites": counts.get("int3-mixed", 0),
        "int4_sites": counts.get("int4", 0),
        "int8_sites": counts.get("int8", 0),
        "calib_tokens": int(batch * seq),
        "wall_s": round(time.perf_counter() - t_start, 1),
        **stats,
        "block_s": block_s,
    }
    return out, report
