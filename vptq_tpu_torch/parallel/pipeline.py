"""Pipeline-style layer placement: contiguous groups of decoder blocks on
their own devices, activations handed from stage to stage.

Port of ``vptq_tpu/parallel/pipeline.py``. The reference's only
multi-device mechanism is accelerate's layer-wise ``device_map``: each
group of blocks (a stage) lives on one device, and the activations move
to the next stage's device after it, one activation-sized copy a
boundary and no collective. :class:`PipelineRunner` is that, in one
process over a list of devices (on one card every stage may be the same
device). :class:`TPPipelineRunner` composes the axes: each stage spans
a tensor-parallel group of ranks (``parallel/tp.py``), one process a
rank, and a stage's rank ``m`` sends its copy of the activations to rank
``m`` of the next stage.

When to use which:

- tensor parallelism (``parallel/tp.py``): every device works on every
  token; the collectives are activation-sized sums. For latency.
- pipeline parallelism (this module): the least communication, at the
  cost of idle stages (:meth:`PipelineRunner.forward_pipelined`
  interleaves microbatches; a batch-1 decode leaves all stages but one
  idle). For memory capacity.

Each stage holds only its layers' weights and KV buffers. A stage runs
the pieces of ``models.llama.forward`` (``embed`` on the first stage,
``decoder`` over its blocks, ``head`` on the last), so a fresh chunk of
1024 tokens or more reaches the flash-attention kernel K8 in every stage
as it does in ``forward``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from vptq_tpu_torch.models.llama import (
    KVCache,
    Model,
    ModelConfig,
    advance,
    decoder,
    embed,
    head,
    init_cache,
)
from vptq_tpu_torch.parallel.distributed import local_device, recv, send

__all__ = ["PipelineRunner", "TPPipelineRunner", "pp_stage_of"]


def pp_stage_of(layer_idx: int, n_layers: int, n_stages: int) -> int:
    """Contiguous block → stage assignment, the remainder to the first
    stages (10 layers over 4 stages: 3, 3, 2, 2)."""
    base, rem = divmod(n_layers, n_stages)
    boundary = rem * (base + 1)
    if layer_idx < boundary:
        return layer_idx // (base + 1)
    return rem + (layer_idx - boundary) // base


@dataclasses.dataclass
class _Stage:
    """One pipeline stage: a slice of a :class:`Model`."""

    blocks: List[Any]
    cfg: ModelConfig
    inv_freq: torch.Tensor
    rope_scale: float
    # the first stage's lookup; the last stage's head when tied
    embed_tokens: Optional[torch.Tensor] = None
    norm: Optional[torch.Tensor] = None  # last stage only
    lm_head: Any = None  # last stage only


def _stage_step(stage: _Stage, x: torch.Tensor, cache: KVCache, dtype,
                first: bool, last: bool, fresh: bool, tp=None):
    """One stage's part of ``models.llama.forward``: ``x`` is (B, S) token
    ids on the first stage, else (B, S, hidden) activations; ``cache``
    holds this stage's layers only (block ``j`` of the stage reads layer
    ``j``) and advances by S. Returns the activations, or on the last
    stage the (B, S, vocab) f32 logits."""
    if first:
        x = embed(stage.embed_tokens, x, stage.cfg, dtype, tp)
    seq = x.shape[1]
    x = decoder(stage.blocks, x, cache, stage.cfg, stage.inv_freq,
                stage.rope_scale, fresh, tp)
    advance(cache, seq)
    if not last:
        return x
    return head(x, stage.norm, stage.lm_head, stage.embed_tokens, stage.cfg,
                tp)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _put(module, device: torch.device):
    """``module`` on ``device``: itself where every tensor of it lies there
    already (stages that share a card share the model's weights), else a
    copy whose tensors are moved there, the model left as it is (JAX's
    ``device_put``)."""
    if module is None:
        return None
    if isinstance(module, torch.Tensor):
        return module.to(device)
    tensors = [*module.parameters(), *module.buffers()]
    if all(t.device == device for t in tensors):
        return module
    return copy.deepcopy(module, {id(t): t.to(device) for t in tensors})


def _stage_cache(cfg: ModelConfig, layers: int, batch: int, max_seq: int,
                 dtype, device, tp_size: int = 1) -> KVCache:
    """A cache of ``layers`` layers: a stage's."""
    return init_cache(dataclasses.replace(cfg, num_hidden_layers=layers),
                      batch, max_seq, dtype, device, tp_size=tp_size)


def _rows_of(cache: KVCache, b0: int, b1: int) -> KVCache:
    """Rows ``b0:b1`` of ``cache`` as a cache of their own: a copy (JAX's
    slice is one), so that the stage's cache stays as it was."""
    return KVCache(
        k=[t[b0:b1].clone() for t in cache.k],
        v=[t[b0:b1].clone() for t in cache.v],
        lengths=cache.lengths[b0:b1].clone(),
        max_len=cache.max_len,
    )


class PipelineRunner:
    """Layer-wise pipeline over explicit devices, in one process.

    ``forward(tokens)`` computes what ``models.llama.forward`` computes
    (the same functions, stage by stage); the activations move to the next
    stage's device with one ``.to`` a boundary. Stage ``s`` holds its
    blocks, the embedding on the first stage, the norm and the lm_head on
    the last (a tied embedding is copied there when the stages are more
    than one), and a cache of its own layers (``self.caches[s]``)."""

    def __init__(
        self,
        model: Model,
        devices: Sequence,
        max_seq: int = 2048,
        batch: int = 1,
        dtype=torch.bfloat16,
    ):
        L = len(model.blocks)
        n = len(devices)
        if n < 1 or L < n:
            raise ValueError(f"{L} layers cannot spread over {n} devices")
        self.devices = [_device(d) for d in devices]
        self.dtype = dtype
        self.cfg = model.cfg
        self.n_stages = n
        self.stages: List[_Stage] = []
        self.caches: List[KVCache] = []
        for s, dev in enumerate(self.devices):
            idxs = [i for i in range(L) if pp_stage_of(i, L, n) == s]
            last = s == n - 1
            tied_here = last and model.lm_head is None
            self.stages.append(_Stage(
                blocks=[_put(model.blocks[i], dev) for i in idxs],
                cfg=model.cfg,
                inv_freq=_put(model.inv_freq, dev),
                rope_scale=model.rope_scale,
                embed_tokens=(_put(model.embed_tokens, dev)
                              if s == 0 or tied_here else None),
                norm=_put(model.norm, dev) if last else None,
                lm_head=_put(model.lm_head, dev) if last else None,
            ))
            self.caches.append(
                _stage_cache(model.cfg, len(idxs), batch, max_seq, dtype, dev))

    # the hooks TPPipelineRunner replaces: which stages this process
    # runs, how a stage's input arrives and where its output goes

    def _here(self) -> Sequence[int]:
        return range(self.n_stages)

    def _arrive(self, s: int, x, tokens):
        """Stage ``s``'s input: the tokens or the previous stage's
        activations, moved onto its device."""
        return x.to(self.devices[s])

    def _leave(self, s: int, out):
        return out

    def _drain(self) -> None:
        pass

    def _run_stage(self, s: int, x, cache, first, last, fresh):
        return _stage_step(self.stages[s], x, cache, self.dtype, first, last,
                           fresh)

    def _schedule(self, chunks, caches: Dict[int, List[KVCache]],
                  fresh: bool) -> list:
        """The 1F schedule: at tick ``t`` stage ``s`` runs microbatch
        ``t - s`` on its cache ``caches[s][t - s]``; n + m - 1 ticks, of
        which each stage is idle n - 1. Returns the last stage's outputs
        per microbatch."""
        n, m = self.n_stages, len(chunks)
        acts: list = [None] * m
        outs: list = [None] * m
        for tick in range(n + m - 1):
            for s in self._here():
                i = tick - s
                if not 0 <= i < m:
                    continue
                x = self._arrive(s, chunks[i] if s == 0 else acts[i],
                                 chunks[i])
                out = self._run_stage(s, x, caches[s][i], s == 0, s == n - 1,
                                      fresh)
                if s == n - 1:
                    outs[i] = out
                else:
                    acts[i] = self._leave(s, out)
        self._drain()
        return outs

    def forward(self, tokens: torch.Tensor, fresh: bool = False):
        """One decode or prefill step across all stages; returns the (B, S,
        vocab) f32 logits (the stages' caches advance in place)."""
        return self._schedule(
            [tokens], {s: [self.caches[s]] for s in self._here()}, fresh)[0]

    def forward_pipelined(self, token_chunks: Sequence[torch.Tensor],
                          fresh: bool = False) -> list:
        """Microbatches through the 1F schedule: ``token_chunks`` are
        independent (B_i, S) microbatches; at tick ``t`` stage ``s`` runs
        microbatch ``t - s``, so every stage is busy once the pipe fills
        (on devices of their own; stages that share one card take turns).
        The bubble is (n_stages - 1) / (n_stages + n_micro - 1) of the
        ticks.

        Each microbatch keeps caches of its own (``self.mb_caches[s][i]``),
        copies of its rows of the stage caches made at the first call with
        this many microbatches; the stage caches are left as they were.
        Returns the per-microbatch logits."""
        m = len(token_chunks)
        mb = getattr(self, "mb_caches", None)
        if mb is None or len(next(iter(mb.values()))) != m:
            offs = [0]
            for t in token_chunks:
                offs.append(offs[-1] + int(t.shape[0]))
            rows = int(self.caches[self._here()[0]].lengths.shape[0])
            if offs[-1] > rows:
                raise ValueError(
                    f"microbatch rows {offs[-1]} exceed cache batch {rows}")
            self.mb_caches = {
                s: [_rows_of(self.caches[s], offs[i], offs[i + 1])
                    for i in range(m)]
                for s in self._here()
            }
        return self._schedule(token_chunks, self.mb_caches, fresh)


class TPPipelineRunner(PipelineRunner):
    """Pipeline × tensor parallelism: stages that each span a group of
    ``tp`` ranks.

    Every rank of the default process group constructs it with the same
    arguments (the whole model, as JAX's takes it): the world is
    ``n_stages × tp`` ranks, stage ``s`` the ranks ``s·tp … (s+1)·tp − 1``
    with a model-axis group of its own (JAX builds a sub-mesh a stage).
    A rank places only its own stage: its blocks by ``tp_place_block``
    (fused projections permuted, row-parallel layers in the blocked
    encoding), the embedding whole on the first stage, the norm whole and
    the lm_head column-parallel on the last, and its shard of the stage's
    cache (its KV heads). Activations enter and leave a stage replicated
    over its group: rank ``(s, m)`` sends its copy to rank ``(s+1, m)``,
    one activation-sized transfer a rank and boundary (through the host on
    gloo, ``distributed.via_host``), and no other collective.

    Every rank calls :meth:`forward` with the same tokens. The logits
    exist on the last stage's ranks only: there ``forward`` returns them,
    elsewhere None (JAX's single controller simply holds them).
    :meth:`forward_pipelined` keeps the 1F schedule, each send posted
    without a wait. ``device`` None: ``distributed.local_device()``, which
    raises without CUDA."""

    def __init__(
        self,
        model: Model,
        tp: int,
        max_seq: int = 2048,
        batch: int = 1,
        dtype=torch.bfloat16,
        device=None,
    ):
        from vptq_tpu_torch.parallel.mesh import Mesh
        from vptq_tpu_torch.parallel.tp import (
            _col_parallel,
            _own,
            tp_place_block,
            tp_validate,
        )

        world = dist.get_world_size()
        if tp < 1 or world % tp:
            raise ValueError(
                f"{world} devices do not split into tp={tp} groups")
        n = world // tp
        L = len(model.blocks)
        if n < 1 or L < n:
            raise ValueError(f"{L} layers cannot spread over {n} stages")
        tp_validate(model.cfg, tp, sharded_lm_head=model.lm_head is not None)
        if model.lm_head is None and n > 1:
            raise NotImplementedError(
                "tied-embedding lm_head on the last TP stage: load with an "
                "untied lm_head or use single-stage TP"
            )
        device = _device(device) if device is not None else local_device()
        rank = dist.get_rank()
        # every rank makes every stage's group, in one order
        groups = [dist.new_group(list(range(s * tp, (s + 1) * tp)))
                  for s in range(n)]
        self.stage, self.tp = rank // tp, tp
        self.mesh = Mesh(data=1, model=tp, rank=rank % tp, device=device,
                         model_group=groups[self.stage])
        self.dtype = dtype
        self.cfg = model.cfg
        self.n_stages = n
        s, mesh = self.stage, self.mesh
        idxs = [i for i in range(L) if pp_stage_of(i, L, n) == s]
        first, last = s == 0, s == n - 1
        self.stages = {s: _Stage(
            blocks=[tp_place_block(model.blocks[i], mesh, model.cfg)
                    for i in idxs],
            cfg=model.cfg,
            inv_freq=_own(model.inv_freq, device),
            rope_scale=model.rope_scale,
            # tied: the whole embedding is the head too (one stage only)
            embed_tokens=(_own(model.embed_tokens, device)
                          if first or (last and model.lm_head is None)
                          else None),
            norm=_own(model.norm, device) if last else None,
            lm_head=(_col_parallel(model.lm_head, mesh)
                     if last and model.lm_head is not None else None),
        )}
        # this rank's KV heads of the stage's layers: shard_cache_tp of the
        # stage's whole cache, made at its shard's shape
        self.caches = {s: _stage_cache(model.cfg, len(idxs), batch, max_seq,
                                       dtype, device, tp_size=tp)}
        self._sends: list = []

    def _here(self) -> Sequence[int]:
        return [self.stage]

    def _peer(self, s: int) -> int:
        """Stage ``s``'s rank at this rank's place in its group."""
        return s * self.tp + self.mesh.model_rank

    def _arrive(self, s: int, x, tokens):
        if s == 0:
            return tokens.to(self.mesh.device)
        out = torch.empty((*tokens.shape, self.cfg.hidden_size),
                          dtype=self.dtype, device=self.mesh.device)
        return recv(out, self._peer(s - 1))

    def _leave(self, s: int, out):
        self._sends.append(send(out, self._peer(s + 1)))
        return None

    def _drain(self) -> None:
        for p in self._sends:
            p.wait()
        self._sends = []

    def _run_stage(self, s: int, x, cache, first, last, fresh):
        return _stage_step(self.stages[s], x, cache, self.dtype, first, last,
                           fresh, tp=self.mesh.tp)
