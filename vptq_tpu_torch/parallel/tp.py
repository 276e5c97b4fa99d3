"""Megatron tensor parallelism: a rank's shard of a model, and the
sharded forward.

Port of ``vptq_tpu/parallel/tp.py``. JAX runs the whole step in
``shard_map`` over a placed pytree; here each rank holds
only its own shard, a plain :class:`~vptq_tpu_torch.models.llama.Model`
of local modules on its own device, and runs ``models.llama.forward``
with ``tp=mesh.tp``: every kernel call sees a local shard, and the only
collectives are one sum after each row-parallel projection and MoE
combine (activation-sized), one after the vocabulary-range embedding
lookup, and one gather of the vocabulary-sharded logits. A fresh prefill
may also split its prompt over the data axis (:func:`prefill_cp`, ring
attention between the chunks).

Placement (:func:`tp_place_model`: the device-``d`` shard of what the JAX
package's ``tp_place_model`` puts on the mesh, byte for byte), per role:

- column-parallel (q/k/v, gate/up, lm_head): this rank's slice of the
  out axis. Fused q|k|v and gate|up rows are permuted first, so that a
  rank's contiguous slice is ``[q_d|k_d|v_d]`` (``[gate_d|up_d]``),
  biases with them.
- row-parallel (o_proj, down_proj): the in axis in the blocked encoding
  (``layers.runtime._encode_*(shards=n)``), each rank's column block a
  standard layer for its kernel; a bf16 layer's columns sliced.
- MoE: the stacked experts split on the expert dim (whole experts per
  rank, ``parallel/expert_parallel.py``); the router whole.
- MLA: the compressed projections and their norms whole, the per-head
  tensors (q / q_b, uk, uv) over heads, o_proj row-parallel.
- the embedding over the vocabulary when the lm_head is untied (whole
  when tied: it is the lm_head then); the norms whole.
- a codebook layer (``VQLinear``; the JAX package places it by GSPMD,
  ``parallel/sharding.py`` ``_shard_vq``): column-parallel, its index
  planes split on the out axis (axis 1) with its bias; row-parallel, on
  the group columns (axis 2), with ``weight_scale`` / ``weight_bias`` at
  the rank's input columns (:class:`VQRowShard`); codebooks and the
  permutation whole. A plane that the model axis does not divide stays
  whole, as JAX's ``_put`` replicates it: the column-parallel layer then
  computes every row and keeps its own (:class:`VQOutRows`), the
  row-parallel one is held by model rank 0 alone, so that the sum counts
  it once.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vptq_tpu_torch.layers.dense import DenseLinear
from vptq_tpu_torch.layers.runtime import (
    BLOCKED_IN_AXES,
    Int2Linear,
    Int3Linear,
    Int4Linear,
    Int8Linear,
    _encode_int2,
    _encode_int3,
    _encode_int4,
    _encode_int8,
    _MixedLinear,
    linear_exact_weight,
)
from vptq_tpu_torch.layers.vqlinear import VQLinear
from vptq_tpu_torch.models.llama import (
    Attention,
    Block,
    DeepseekMoe,
    KVCache,
    MlaAttention,
    Mlp,
    Model,
    MoeMlp,
    StackedExperts,
    forward,
    init_cache,
)
from vptq_tpu_torch.parallel.distributed import all_gather_last, broadcast
from vptq_tpu_torch.parallel.expert_parallel import shard_stacked_experts
from vptq_tpu_torch.parallel.mesh import Mesh

__all__ = [
    "ShardSum",
    "VQOutRows",
    "VQRowShard",
    "batch_axis",
    "cp_logits_row",
    "forward_tp",
    "init_cache_tp",
    "prefill_cp",
    "shard_cache_tp",
    "shards_summed",
    "tp_place_block",
    "tp_place_model",
    "tp_validate",
]


def tp_validate(cfg, size: int, sharded_lm_head: bool = True) -> None:
    """Raise when the geometry cannot be Megatron-sharded ``size`` ways
    (head / intermediate / vocabulary divisibility; the JAX package's
    messages)."""
    checks = [("num_attention_heads", cfg.num_attention_heads)]
    if not cfg.is_mla:
        # MLA's widths (dense-replace, shared and routed experts) are
        # checked at placement, from the layers themselves
        checks += [
            ("num_key_value_heads", cfg.num_key_value_heads),
            ("intermediate_size", cfg.intermediate_size),
        ]
    if sharded_lm_head:
        checks.append(("vocab_size", cfg.vocab_size))
    for name, val in checks:
        if val % size:
            raise ValueError(f"{name}={val} does not divide TP size {size}")


def _own(t: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    """A contiguous copy of ``t`` on ``device`` that shares no storage with
    the whole tensor (so that the whole one can be freed)."""
    if t is None:
        return None
    return t.to(device).clone(memory_format=torch.contiguous_format)


def _rows(t, lo, hi, dim, device):
    return None if t is None else _own(t.narrow(dim, lo, hi - lo), device)


def _fused_perm(sections, size: int) -> torch.Tensor:
    """Row permutation turning [A|B|...] into per-shard [A_d|B_d|...];
    each section length divides by ``size``."""
    perm, off = [], 0
    offs = []
    for sec in sections:
        offs.append(off)
        off += sec
    for d in range(size):
        for sec, o in zip(sections, offs):
            blk = sec // size
            perm.extend(range(o + d * blk, o + (d + 1) * blk))
    return torch.tensor(perm, dtype=torch.int64)


# the arrays of each linear and the dim of each that runs along
# out_features (int8 / int4 scales are stored transposed); along
# in_features: layers/runtime.py BLOCKED_IN_AXES
_OUT_DIM = {
    Int8Linear: {"wq": 0, "scales": 1, "bias": 0},
    Int4Linear: {"wq": 0, "scales": 1, "bias": 0},
    Int3Linear: {"wq2": 0, "wq1": 0, "scales": 0, "bias": 0},
    Int2Linear: {"wq": 0, "scales": 0, "bias": 0},
    DenseLinear: {"weight": 0, "bias": 0},
}


def _unsupported(layer):
    return NotImplementedError(
        f"tensor parallelism does not support {type(layer).__name__}; use "
        "a runtime format (int8/int4/int3/int2/bf16)"
    )


def _permute_out(layer, perm: torch.Tensor):
    """A linear with its output rows reordered by ``perm``."""
    if isinstance(layer, _MixedLinear):
        # both sides are row-major over out_features; the column
        # selection is input-side and unaffected
        return type(layer)(
            _permute_out(layer.base, perm), _permute_out(layer.int8, perm),
            layer.col_idx,
            None if layer.bias is None else layer.bias[perm.to(
                layer.bias.device)],
        )
    dims = _OUT_DIM.get(type(layer))
    if dims is None:
        raise _unsupported(layer)
    arrays = {}
    for name, dim in dims.items():
        t = getattr(layer, name)
        arrays[name] = (None if t is None
                        else t.index_select(dim, perm.to(t.device)))
    return type(layer)(**arrays)


def _out_features(layer) -> int:
    if isinstance(layer, _MixedLinear):
        return layer.base.out_features
    if isinstance(layer, DenseLinear):
        return int(layer.weight.shape[0])
    return layer.out_features


def _col_parallel(layer, mesh, perm: Optional[torch.Tensor] = None):
    """This rank's slice of a column-parallel linear (out axis)."""
    if isinstance(layer, VQLinear):
        return _vq_col_parallel(layer, mesh, perm)
    if perm is not None:
        layer = _permute_out(layer, perm)
    n, r = mesh.model, mesh.model_rank
    out_f = _out_features(layer)
    if out_f % n:
        raise ValueError(f"out_features {out_f} does not divide TP size {n}")
    lo, hi = r * out_f // n, (r + 1) * out_f // n
    if isinstance(layer, _MixedLinear):
        # both sides over the out axis; the column selection gathers from
        # the whole activations, so col_idx is every rank's
        return type(layer)(
            _col_parallel(layer.base, mesh), _col_parallel(layer.int8, mesh),
            _own(layer.col_idx, mesh.device),
            _rows(layer.bias, lo, hi, 0, mesh.device),
        )
    dims = _OUT_DIM.get(type(layer))
    if dims is None:
        raise _unsupported(layer)
    return type(layer)(**{
        name: _rows(getattr(layer, name), lo, hi, dim, mesh.device)
        for name, dim in dims.items()
    })


def _in_slice(layer, mesh):
    """This rank's column block of a linear already in the blocked layout
    (each of its in-axis arrays split in ``mesh.model`` equal parts)."""
    n, r = mesh.model, mesh.model_rank
    arrays = {}
    for name, dim in BLOCKED_IN_AXES[type(layer)].items():
        t = getattr(layer, name)
        size = t.shape[dim]
        if size % n:
            raise ValueError(
                f"{type(layer).__name__}.{name} {tuple(t.shape)} is not in "
                f"the blocked layout of {n} shards"
            )
        arrays[name] = _rows(t, r * size // n, (r + 1) * size // n, dim,
                             mesh.device)
    return type(layer)(**arrays, bias=None)


_BLOCKED_ENCODE = {
    Int8Linear: _encode_int8, Int4Linear: _encode_int4,
    Int3Linear: _encode_int3, Int2Linear: _encode_int2,
}


def _row_parallel(layer, mesh, logical_in: int, reencode: bool = True):
    """This rank's block of a row-parallel linear (in axis, blocked).

    ``logical_in``: the unpadded in_features (from the geometry), so that
    a re-encode splits the real columns, not one device's zero padding.
    ``reencode=False``: the layer is already blocked (the loader encodes
    row-parallel layers with ``row_shards`` straight from the exact
    weights) and is only sliced.
    """
    if getattr(layer, "bias", None) is not None:
        raise NotImplementedError(
            "row-parallel layer with bias under shard_map TP (no "
            "supported family needs it: llama/mistral/qwen2/phi3 "
            "o_proj/down_proj are bias-free)"
        )
    n = mesh.model
    if isinstance(layer, VQLinear):
        return _vq_row_parallel(layer, mesh)
    if isinstance(layer, _MixedLinear):
        if reencode:
            raise NotImplementedError(
                "row-parallel int3-/int2-mixed must come pre-blocked "
                "from the calibrated encoder (load with calibration= "
                "and a TP mesh, quant/calibrate.py tp_shards) — an "
                "RTN re-encode would discard the calibrated column "
                "selection"
            )
        # calibrated blocked form: the base's in axis and the side's
        # selected columns per shard, col_idx shard-local
        k = layer.col_idx.shape[0]
        side = layer.int8
        return type(layer)(
            _in_slice(layer.base, mesh),
            _in_slice(side, mesh),
            _rows(layer.col_idx, mesh.model_rank * k // n,
                  (mesh.model_rank + 1) * k // n, 0, mesh.device),
        )
    if isinstance(layer, DenseLinear):
        w = F.pad(layer.weight[:, :logical_in],
                  (0, (-logical_in) % n))
        blk = w.shape[1] // n
        return DenseLinear(
            weight=_rows(w, mesh.model_rank * blk,
                         (mesh.model_rank + 1) * blk, 1, mesh.device),
            bias=None,
        )
    encode = _BLOCKED_ENCODE.get(type(layer))
    if encode is None:
        raise _unsupported(layer)
    if reencode:
        kwargs = {"group": layer.group} if isinstance(layer, Int2Linear) else {}
        layer = encode(linear_exact_weight(layer, logical_in), None,
                       shards=n, **kwargs)
    return _in_slice(layer, mesh)


def _vq_planes(layer: VQLinear, device, **sliced) -> dict:
    """Every plane of ``layer`` on ``device`` (a copy of each), those in
    ``sliced`` replaced by the given tensors."""
    planes = {name: _own(getattr(layer, name), device) for name in (
        "centroids", "ids", "res_centroids", "res_ids", "outlier_centroids",
        "outlier_ids", "inv_perm", "weight_scale", "weight_bias", "bias")}
    planes.update({k: _own(v, device) for k, v in sliced.items()})
    return planes


class VQOutRows(nn.Module):
    """A whole codebook layer of which this rank keeps the output rows
    ``rows``: the column-parallel placement of a layer whose index planes
    the model axis does not divide (JAX's ``_put`` replicates them), or
    whose rows a fused projection permutes."""

    def __init__(self, layer: VQLinear, rows: torch.Tensor):
        super().__init__()
        self.layer = layer
        self.register_buffer("rows", rows)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x).index_select(-1, self.rows)

    @property
    def out_features(self) -> int:
        return int(self.rows.shape[0])


def _vq_col_parallel(layer: VQLinear, mesh, perm=None):
    """This rank's rows of a column-parallel codebook layer: the index
    planes (and outlier ids) split on axis 1 with the bias when the model
    axis divides every one of them whole vectors, else the whole layer and
    its rows (:class:`VQOutRows`)."""
    n, r, dev = mesh.model, mesh.model_rank, mesh.device
    cfg = layer.cfg
    out_f = cfg.out_features
    if out_f % n:
        raise ValueError(f"out_features {out_f} does not divide TP size {n}")
    lo, hi = r * out_f // n, (r + 1) * out_f // n
    split = perm is None and cfg.padding == 0 and cfg.num_indices % n == 0
    if cfg.enable_outlier:
        split = split and (cfg.outlier_padding == 0
                           and cfg.outlier_num_indices % n == 0)
    if not split:
        rows = (torch.arange(lo, hi) if perm is None else perm[lo:hi])
        return VQOutRows(_whole(layer, dev), rows.to(dev))
    ni, oi = cfg.num_indices // n, cfg.outlier_num_indices // n
    sliced = {"ids": layer.ids[:, r * ni:(r + 1) * ni]}
    if layer.res_ids is not None:
        sliced["res_ids"] = layer.res_ids[:, r * ni:(r + 1) * ni]
    if layer.outlier_ids is not None:
        sliced["outlier_ids"] = layer.outlier_ids[:, r * oi:(r + 1) * oi]
    if layer.bias is not None:
        sliced["bias"] = layer.bias[lo:hi]
    return VQLinear(**_vq_planes(layer, dev, **sliced),
                    cfg=dataclasses.replace(cfg, out_features=hi - lo))


class VQRowShard(nn.Module):
    """This rank's block of a row-parallel codebook layer: the stored
    columns its index planes hold (a slice of each codebook's group and of
    the outliers), run on the input columns they stand for.

    ``cols`` None and ``gather`` False: those are the rank's own block of
    the activations (no permutation, one codebook, no outliers), which it
    is given. ``gather``: the activations of every rank are gathered
    first (the model axis's ``all_gather``; GSPMD placed that gather in
    the JAX package), then ``cols`` picked from them, the input columns
    of the rank's stored ones through the permutation, or, ``cols`` None,
    all of them for a whole layer. ``layer`` None: this rank holds none
    of the layer (the whole of it lies on model rank 0) and adds zeros to
    the sum."""

    def __init__(self, layer: Optional[VQLinear], cols, gather: bool, tp,
                 out_features: int):
        super().__init__()
        self.layer = layer
        self.register_buffer("cols", cols)
        self.gather, self.tp, self._out = gather, tp, out_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gather:
            x = all_gather_last(x, self.tp)
        if self.layer is None:
            return x.new_zeros((*x.shape[:-1], self._out))
        if self.cols is not None:
            x = x.index_select(-1, self.cols)
        return self.layer(x)

    @property
    def out_features(self) -> int:
        return self._out


def _vq_row_parallel(layer: VQLinear, mesh) -> VQRowShard:
    """This rank's block of a row-parallel codebook layer (the group
    columns, ids axis 2, with the norm's entries at them); the whole
    layer on model rank 0 when the model axis does not divide a
    codebook's group or the outliers."""
    n, r, dev = mesh.model, mesh.model_rank, mesh.device
    cfg = layer.cfg
    gs = cfg.group_size
    osz = cfg.outlier_size if cfg.enable_outlier else 0
    if gs % n or osz % n:
        whole = _whole(layer, dev) if r == 0 else None
        return VQRowShard(whole, None, True, mesh.tp, cfg.out_features)
    g, o = gs // n, osz // n
    stored = [torch.arange(r * o, (r + 1) * o)] + [
        osz + c * gs + torch.arange(r * g, (r + 1) * g)
        for c in range(cfg.num_codebooks)]
    stored = torch.cat(stored)
    # the input column each stored one stands for: W[:, j] = Q[:, inv[j]]
    # (on the meta device, a plan's step, only their count)
    if layer.inv_perm is None:
        cols = stored
    elif layer.inv_perm.is_meta:
        cols = torch.empty_like(stored, device="meta")
    else:
        cols = torch.argsort(layer.inv_perm.to("cpu", torch.int64))[stored]
    sliced = {"ids": layer.ids[:, :, r * g:(r + 1) * g], "inv_perm": None}
    if layer.res_ids is not None:
        sliced["res_ids"] = layer.res_ids[:, :, r * g:(r + 1) * g]
    if layer.outlier_ids is not None:
        sliced["outlier_ids"] = layer.outlier_ids[:, :, r * o:(r + 1) * o]
    if layer.weight_scale is not None:
        at = cols.to(layer.weight_scale.device)
        sliced["weight_scale"] = layer.weight_scale.index_select(0, at)
        sliced["weight_bias"] = layer.weight_bias.index_select(0, at)
    sub = VQLinear(**_vq_planes(layer, dev, **sliced), cfg=dataclasses.replace(
        cfg, in_features=cfg.in_features // n, group_size=g,
        outlier_size=o if cfg.enable_outlier else cfg.outlier_size,
        enable_perm=False))
    lo = r * cfg.in_features // n
    if not cols.is_meta and torch.equal(
            cols, torch.arange(lo, lo + cols.shape[0])):
        return VQRowShard(sub, None, False, mesh.tp, cfg.out_features)
    return VQRowShard(sub, cols.to(dev), True, mesh.tp, cfg.out_features)


class ShardSum(nn.Module):
    """A blocked row-parallel linear (``shards`` > 1) run on one device as
    tensor parallelism computes it: x zero-padded to a multiple of the
    shards and cut into their column blocks, each block through its
    shard's layer (:func:`_row_parallel`'s slice, the one rank ``s`` of
    the mesh holds), the outputs summed in x's dtype, where the ranks'
    ``all_reduce`` sums them. No collective: every shard lies here."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        n = layer.shards
        device = next(iter(layer.buffers())).device
        self.parts = nn.ModuleList(
            _row_parallel(layer, Mesh(data=1, model=n, rank=s, device=device),
                          None, reencode=False)
            for s in range(n)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.parts)
        x = F.pad(x, (0, (-x.shape[-1]) % n))
        blk = x.shape[-1] // n
        out = self.parts[0](x[..., :blk].contiguous())
        for s in range(1, n):
            out = out + self.parts[s](
                x[..., s * blk: (s + 1) * blk].contiguous())
        return out


def shards_summed(module: nn.Module) -> nn.Module:
    """``module`` with every blocked layer in it (one that carries
    ``shards`` > 1: calibration's ``tp_shards`` encodings) run as its
    :class:`ShardSum`, so that the tree computes on one device what its
    placement computes over the ranks. The tree is copied where it
    changes and ``module`` is left as it was; a tree with no blocked
    layer comes back as it is."""
    if getattr(module, "shards", 1) > 1:
        return ShardSum(module)
    new = None
    for name, child in module._modules.items():
        if child is None:
            continue
        summed = shards_summed(child)
        if summed is not child:
            if new is None:
                new = copy.copy(module)
                new._modules = dict(module._modules)
            new._modules[name] = summed
    return module if new is None else new


def _place_mlp(mlp: Mlp, mesh, reencode_rows: bool = True) -> Mlp:
    # the logical intermediate size from the layer itself, so that shared
    # experts and dense-replace MLPs (other widths) place right
    n = mesh.model
    if mlp.gate_up_proj is not None:
        inter = _out_features(mlp.gate_up_proj) // 2
        if inter % n:
            raise ValueError(
                f"mlp intermediate {inter} does not divide TP size {n}")
        gu = _col_parallel(mlp.gate_up_proj, mesh,
                           _fused_perm([inter, inter], n))
        gate = up = None
    else:
        inter = _out_features(mlp.gate_proj)
        if inter % n:
            raise ValueError(
                f"mlp intermediate {inter} does not divide TP size {n}")
        gu = None
        gate = _col_parallel(mlp.gate_proj, mesh)
        up = _col_parallel(mlp.up_proj, mesh)
    down = _row_parallel(mlp.down_proj, mesh, inter, reencode=reencode_rows)
    return Mlp(gate_proj=gate, up_proj=up, down_proj=down, gate_up_proj=gu)


def _local_experts(stacked: Optional[StackedExperts], mesh, what: str):
    if stacked is None:
        raise NotImplementedError(
            f"shard_map TP {what} requires stacked experts (fuse_model)"
        )
    local = shard_stacked_experts(stacked, mesh)
    if local is None:
        raise NotImplementedError(
            f"experts {stacked.gate_up_wq.shape[0]} must divide TP size "
            f"{mesh.model}"
        )
    return local


def _whole(module, device):
    """A replicated module: moved to ``device`` (a copy of every buffer)."""
    if module is None:
        return None
    if isinstance(module, torch.Tensor):
        return _own(module, device)
    return copy.deepcopy(module).to(device)


def _place_moe(moe: MoeMlp, mesh) -> MoeMlp:
    return MoeMlp(
        router=_whole(moe.router, mesh.device), experts=[],
        num_experts_per_tok=moe.num_experts_per_tok,
        stacked=_local_experts(moe.stacked, mesh, "MoE"),
    )


def _place_mla(attn: MlaAttention, mesh, cfg,
               reencode_rows: bool = True) -> MlaAttention:
    """Compressed projections whole (shared by the heads), the per-head
    tensors over heads (a head's rows are contiguous: no permutation),
    o_proj row-parallel (logical in: heads × v_head_dim)."""
    n, r, dev = mesh.model, mesh.model_rank, mesh.device
    nh = cfg.num_attention_heads
    lo, hi = r * nh // n, (r + 1) * nh // n
    kwargs = {}
    if attn.q_proj is not None:
        kwargs["q_proj"] = _col_parallel(attn.q_proj, mesh)
    else:
        kwargs.update(
            q_a_proj=_whole(attn.q_a_proj, dev),
            q_a_norm=_own(attn.q_a_norm, dev),
            q_b_proj=_col_parallel(attn.q_b_proj, mesh),
        )
    return MlaAttention(
        kv_a_proj=_whole(attn.kv_a_proj, dev),
        kv_a_norm=_own(attn.kv_a_norm, dev),
        o_proj=_row_parallel(attn.o_proj, mesh, nh * cfg.v_head_dim,
                             reencode=reencode_rows),
        uk=_rows(attn.uk, lo, hi, 1, dev),
        uv=_rows(attn.uv, lo, hi, 1, dev),
        **kwargs,
    )


def _place_deepseek_moe(moe: DeepseekMoe, mesh,
                        reencode_rows: bool = True) -> DeepseekMoe:
    return DeepseekMoe(
        router_weight=_own(moe.router_weight, mesh.device),
        correction_bias=_own(moe.correction_bias, mesh.device),
        experts=[],
        shared_experts=_place_mlp(moe.shared_experts, mesh, reencode_rows),
        top_k=moe.top_k, n_group=moe.n_group, topk_group=moe.topk_group,
        norm_topk_prob=moe.norm_topk_prob,
        routed_scaling_factor=moe.routed_scaling_factor,
        stacked=_local_experts(moe.stacked, mesh, "DeepseekMoe"),
    )


def tp_place_block(block: Block, mesh, cfg,
                   reencode_rows: bool = True) -> Block:
    """This rank's shard of one decoder block (the loader places each
    block as it is built, so one block at most exists whole).
    ``reencode_rows=False`` when the row-parallel layers are already
    blocked (``to_runtime(..., row_shards=n)``)."""
    n = mesh.model
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    attn = block.attn
    if isinstance(attn, MlaAttention):
        attn_p = _place_mla(attn, mesh, cfg, reencode_rows)
    else:
        if attn.qkv_proj is not None:
            qkv = _col_parallel(
                attn.qkv_proj, mesh, _fused_perm([nh * hd, nkv * hd,
                                                  nkv * hd], n))
            q = k = v = None
        else:
            qkv = None
            q, k, v = (_col_parallel(p, mesh)
                       for p in (attn.q_proj, attn.k_proj, attn.v_proj))
        attn_p = Attention(
            q_proj=q, k_proj=k, v_proj=v,
            o_proj=_row_parallel(attn.o_proj, mesh, nh * hd,
                                 reencode=reencode_rows),
            qkv_proj=qkv,
        )
    if isinstance(block.mlp, MoeMlp):
        mlp_p = _place_moe(block.mlp, mesh)
    elif isinstance(block.mlp, DeepseekMoe):
        mlp_p = _place_deepseek_moe(block.mlp, mesh, reencode_rows)
    else:
        mlp_p = _place_mlp(block.mlp, mesh, reencode_rows)
    return Block(
        input_layernorm=_own(block.input_layernorm, mesh.device),
        attn=attn_p,
        post_attention_layernorm=_own(block.post_attention_layernorm,
                                      mesh.device),
        mlp=mlp_p,
    )


def place_embedding(embed: torch.Tensor, lm_head, mesh) -> torch.Tensor:
    """The embedding of this rank: its vocabulary range when the lm_head
    is untied (the forward looks up the range and sums), whole when tied
    (it is the lm_head then)."""
    if lm_head is None:
        return _own(embed, mesh.device)
    v = embed.shape[0]
    r, n = mesh.model_rank, mesh.model
    return _rows(embed, r * v // n, (r + 1) * v // n, 0, mesh.device)


def tp_place_model(model: Model, mesh, reencode_rows: bool = True) -> Model:
    """This rank's shard of a fused runtime model (``fuse_model``), on
    ``mesh.device``: what the JAX package's ``tp_place_model`` places on
    device ``mesh.rank`` of a data-1 mesh.

    The shard is only valid through :func:`forward_tp` (or ``forward``
    with ``tp=mesh.tp``): row-parallel layers are blocked and fused
    projections permuted. ``reencode_rows=False`` when the row-parallel
    layers are already blocked."""
    cfg = model.cfg
    tp_validate(cfg, mesh.model, sharded_lm_head=model.lm_head is not None)
    blocks = [tp_place_block(b, mesh, cfg, reencode_rows)
              for b in model.blocks]
    lm_head = (None if model.lm_head is None
               else _col_parallel(model.lm_head, mesh))
    return Model(
        embed_tokens=place_embedding(model.embed_tokens, model.lm_head, mesh),
        blocks=blocks, norm=_own(model.norm, mesh.device), lm_head=lm_head,
        cfg=cfg,
    )


def batch_axis(mesh, batch: int) -> Optional[str]:
    """The mesh axis the batch rides: ``data`` when it divides the batch
    (DP × TP), else None (every data rank runs the whole batch)."""
    return "data" if mesh.data > 1 and batch % mesh.data == 0 else None


def init_cache_tp(cfg, batch: int, max_seq: int, dtype, mesh) -> KVCache:
    """This rank's shard of a cache of ``batch`` sequences: its KV heads (a
    MLA latent cache whole), and its rows of the batch when the batch
    rides the data axis (:func:`batch_axis`)."""
    local = batch // mesh.data if batch_axis(mesh, batch) else batch
    return init_cache(cfg, local, max_seq, dtype, mesh.device,
                      tp_size=mesh.model)


def shard_cache_tp(cache: KVCache, mesh) -> KVCache:
    """This rank's shard of a whole cache: heads over the model axis (a
    cache of one latent head whole), batch rows over the data axis when
    they divide it; lengths with the rows."""
    batch = cache.lengths.shape[0]
    rows = slice(None)
    if batch_axis(mesh, batch):
        b = batch // mesh.data
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)

    def take(buf):
        heads = buf.shape[2]
        if heads > 1:
            h = heads // mesh.model
            buf = buf[:, :, mesh.model_rank * h: (mesh.model_rank + 1) * h]
        return _own(buf[rows], mesh.device)

    return KVCache(
        k=[take(b) for b in cache.k], v=[take(b) for b in cache.v],
        lengths=_own(cache.lengths[rows], mesh.device),
        max_len=cache.max_len,
    )


def forward_tp(
    model_tp: Model,
    tokens: torch.Tensor,  # (B, S), the same on every rank
    cache: KVCache,  # this rank's shard (init_cache_tp / shard_cache_tp)
    mesh,
    dtype=torch.bfloat16,
    fresh_prefill: bool = False,
):
    """The tensor-parallel step over ``mesh``: ``forward`` on this rank's
    shard with ``tp=mesh.tp``. The batch rides the data axis when it
    divides it (each data rank runs its rows); returns (this rank's rows'
    vocabulary-complete logits f32, cache)."""
    if batch_axis(mesh, tokens.shape[0]):
        b = tokens.shape[0] // mesh.data
        tokens = tokens[mesh.data_rank * b: (mesh.data_rank + 1) * b]
    return forward(model_tp, tokens, cache, dtype=dtype,
                   fresh_prefill=fresh_prefill, tp=mesh.tp)



def prefill_cp(
    model_tp: Model,
    tokens: torch.Tensor,  # (B, S), the whole prompt, the same on every rank
    cache: KVCache,  # this rank's heads of every row (not split over data)
    mesh,
    dtype=torch.bfloat16,
):
    """Context-parallel fresh prefill: the prompt's sequence is split over
    the data axis in contiguous chunks, and each data rank runs the whole
    decoder on its chunk (``forward(tp=mesh.tp, cp=mesh.cp)``) while
    attention runs as a K/V ring (``parallel/ring.py``) and tensor
    parallelism over the model axis as usual. The cache comes back whole
    on every data rank with the full prefix written, ready for
    :func:`forward_tp` to decode. S must divide the data axis.

    Returns (this rank's chunk of the logits, (B, S / data, vocab) f32,
    positions ``data_rank * S / data`` on; cache). JAX returns the global
    (B, S, vocab) array, sharded over the data axis; here no rank gathers
    it (at a 128256 vocabulary and 2048 tokens it is 1.05 GB a rank): a
    caller that wants a row takes it from the rank whose chunk holds it
    (:func:`cp_logits_row`)."""
    cp = mesh.data
    if tokens.shape[1] % cp:
        raise ValueError(
            f"prompt length {tokens.shape[1]} must divide cp={cp} chunks"
        )
    c = tokens.shape[1] // cp
    chunk = tokens[:, mesh.data_rank * c: (mesh.data_rank + 1) * c]
    return forward(model_tp, chunk, cache, dtype=dtype, fresh_prefill=True,
                   tp=mesh.tp, cp=mesh.cp)


def cp_logits_row(logits: torch.Tensor, pos: int, mesh) -> torch.Tensor:
    """The (B, vocab) logits of global position ``pos`` of a
    :func:`prefill_cp` on every data rank: the rank whose chunk holds it
    broadcasts the row over the data axis (one row, not the chunks)."""
    chunk = logits.shape[1]
    owner = pos // chunk
    if mesh.data_rank == owner:
        row = logits[:, pos % chunk].contiguous()
    else:
        row = torch.empty((logits.shape[0], logits.shape[2]),
                          dtype=logits.dtype, device=logits.device)
    return broadcast(row, mesh.cp, owner)
