"""Continuous-batching scheduler.

Port of ``vptq_tpu/serving/scheduler.py``, on one device or as one rank
of a mesh (``mesh=``: every rank submits the same requests in the same
order and steps in lockstep; each decision is a function of the requests
and of the tokens, which every rank holds alike). A fixed batch of
sequence slots shares one KV cache, each slot advancing on its own
length, and a finished slot is refilled from the queue. On a data axis
above 1 that divides the slots, each data rank holds and steps its
slots' rows (JAX's ``batch_axis``), and the tokens of every slot reach
every rank by one gather over the data axis a chunk; an admission is
prefilled on every data rank, context-parallel where the JAX package's
rule says so (``generate.takes_cp``), and written into its slot's rows by
the data rank that holds them:

  * admission is chunked and interleaved with decode: each ``step()``
    advances at most ``admit_parallel`` in-flight admissions by one
    prefill bucket. Fresh prompts that fit one bucket are prefilled
    together, one row each, on the first rows of a bucket-length scratch
    cache (under a mesh of data axis 1 too: each rank its KV heads); the
    others, and every prompt on a data axis above 1, on a batch-1 cache
    from a small pool. A finished prefill is written into
    its slot (one copy per layer);
    with every slot taken, requests still prefill ahead and wait ready
    for a slot, which a known-budget handoff gives them as soon as the
    old occupant's last token has been dispatched;
  * decode advances all slots together in chunks of ``chunk`` steps
    (:class:`~vptq_tpu_torch.serving.generate.BatchedDecode`: on a CUDA
    device each step a replayed CUDA graph, on the CPU, or under a gloo
    group, the same step eagerly);
  * chunks are pipelined ``depth`` deep: chunk N+1 is dispatched from
    the tokens and cache left on the device before the host consumes
    chunk N, whose tokens come back through a pinned host buffer and a
    CUDA event. A request's first token, sampled on the device from its
    prefill logits, travels as a 1-token chunk in the same queue. Greedy
    token streams are identical across depths; the cost is up to
    ``(depth - 1) · chunk`` speculative tokens after a request ends,
    dropped when consumed.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from vptq_tpu_torch.models.llama import KVCache, Model, forward, init_cache
from vptq_tpu_torch.parallel.distributed import all_gather_dim
from vptq_tpu_torch.parallel.tp import batch_axis, cp_logits_row, prefill_cp
from vptq_tpu_torch.serving.generate import (
    BatchedDecode,
    _generator,
    _temperature,
    cache_rows,
    sample_next,
    serving_tp,
    takes_cp,
    write_rows,
)

__all__ = ["Request", "Scheduler"]


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    eos_token_id: Optional[int] = None
    stream_callback: Optional[Callable[[int, int], None]] = None
    # filled by the scheduler:
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _InflightChunk:
    """A dispatched, not yet consumed chunk: its (n, B) tokens on their
    way to a host buffer (``event`` marks the copy's end; None on the
    CPU), and the request in each slot at dispatch, so that each column
    goes to the request that made it even if the slot changed since."""

    host: torch.Tensor
    event: Optional[torch.cuda.Event]
    slots: List[Optional[Request]]


@dataclasses.dataclass
class _Admission:
    """A chunked prefill in flight, across ``step()`` calls. ``slot`` is
    None for a prefill-ahead admission (every slot was taken when it
    started). Its K/V rows are row ``row`` of ``cache1``: a pooled batch-1
    cache, or the shared scratch cache of a batched prefill."""

    req: Request
    slot: Optional[int]
    done: int = 0  # prompt tokens prefilled so far
    last_len: int = 0  # real tokens in the latest chunk
    cache1: Optional[KVCache] = None
    row: int = 0
    last_logits: Optional[torch.Tensor] = None  # (V,) of the last real token


@dataclasses.dataclass
class _Ready:
    """A prefilled request waiting for a free slot, on its own pooled
    batch-1 cache."""

    req: Request
    cache1: KVCache
    plen: int
    first: torch.Tensor  # (1,) int64 on the device


class Scheduler:
    def __init__(
        self,
        model: Model,
        max_batch: int = 4,
        max_seq: int = 1024,
        dtype=torch.bfloat16,
        chunk: int = 16,
        prompt_buckets: Sequence[int] = (64, 256, 1024),
        prefix_cache=None,  # serving.prefix_cache.PrefixCache
        mesh=None,
        depth: int = 2,  # decode chunks in flight (1 = synchronous)
        admit_parallel: int = 4,  # admissions advanced per step
    ):
        self.mesh = mesh
        self.tp = serving_tp(mesh)
        self.model = model
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.dtype = dtype
        self.chunk = chunk
        self.prefix_cache = prefix_cache
        self.device = model.embed_tokens.device
        self.prompt_buckets = [b for b in prompt_buckets if b <= max_seq]
        if not self.prompt_buckets:
            self.prompt_buckets = [max_seq]

        self._tp_size = 1 if mesh is None else mesh.model
        # the slots this rank holds and steps: [row0, row0 + rows), all of
        # them unless they ride the data axis
        self._split = mesh is not None and bool(batch_axis(mesh, max_batch))
        self._rows = max_batch // mesh.data if self._split else max_batch
        self._row0 = mesh.data_rank * self._rows if self._split else 0
        self.cache = self._new_cache(self._rows, max_seq)
        self.decode = BatchedDecode(model, self.cache, dtype, chunk,
                                    tp=self.tp)
        self.slots: List[Optional[Request]] = [None] * max_batch
        # each slot's cached length as the host knows it (prompt plus the
        # steps dispatched, capped as the device caps it): the longest
        # active one picks a chunk's graphs
        self._len = [0] * max_batch
        # tokens dispatched for each slot's occupant (the host consumes
        # depth - 1 chunks behind): drives the known-budget handoff
        self._dispatched = [0] * max_batch
        self.depth = max(1, int(depth))
        self.admit_parallel = max(1, int(admit_parallel))
        self.pending: deque[Request] = deque()
        self.finished: Dict[int, Request] = {}
        self._next_id = 0
        self._chunk_idx = 0
        # host wall time: sync_wait_s blocked on the device's results,
        # dispatch_s enqueueing decode chunks, admit_s enqueueing prefills
        self.stats = {
            "sync_wait_s": 0.0,
            "dispatch_s": 0.0,
            "admit_s": 0.0,
            "handoffs": 0,
            "steps": 0,
            "chunks": 0,
            "batched_admissions": 0,
            "prefill_ahead": 0,
        }
        self._admissions: List[_Admission] = []
        self._ready: List[_Ready] = []
        self._inflight: deque[_InflightChunk] = deque()
        # batch-1 caches of max_seq, reused across admissions; the scratch
        # cache of each bucket's batched prefill; pinned host buffers
        self._free_caches: List[KVCache] = []
        self._scratch: Dict[int, KVCache] = {}
        self._host_bufs: Dict[tuple, List[torch.Tensor]] = {}

    # ------------------------------------------------------------ API

    def submit(
        self,
        prompt_tokens: Sequence[int],
        max_new_tokens: int = 64,
        temperature: float = 0.0,
        seed: int = 0,
        eos_token_id: Optional[int] = None,
        stream_callback=None,
    ) -> int:
        prompt = np.asarray(prompt_tokens, dtype=np.int64)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt must be non-empty 1-D")
        if len(prompt) >= self.max_seq:
            raise ValueError("prompt longer than max_seq")
        req = Request(
            req_id=self._next_id,
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            seed=seed,
            eos_token_id=eos_token_id,
            stream_callback=stream_callback,
        )
        self._next_id += 1
        self.pending.append(req)
        return req.req_id

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    # ------------------------------------------------------ device state

    def _new_cache(self, batch: int, max_seq: int) -> KVCache:
        # this rank's KV heads under a mesh
        return init_cache(self.model.cfg, batch, max_seq, self.dtype,
                          self.device, tp_size=self._tp_size)

    def _take_cache(self) -> KVCache:
        if self._free_caches:
            return self._free_caches.pop()
        return self._new_cache(1, self.max_seq)

    def _is_scratch(self, cache1: KVCache) -> bool:
        return any(cache1 is c for c in self._scratch.values())

    def _give_cache(self, cache1: KVCache) -> None:
        # a later use is enqueued after every copy out of it
        if not self._is_scratch(cache1):
            self._free_caches.append(cache1)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            # pinned: the copy is queued, the host does not wait for the
            # chunks in flight
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _to_host(self, toks: torch.Tensor) -> _InflightChunk:
        """Queue the copy of (n, B) tokens to a host buffer."""
        if self.device.type != "cuda":
            return _InflightChunk(toks.clone(), None, list(self.slots))
        bufs = self._host_bufs.setdefault(tuple(toks.shape), [])
        host = bufs.pop() if bufs else torch.empty(
            toks.shape, dtype=toks.dtype, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _InflightChunk(host, event, list(self.slots))

    def _local(self, slot: int) -> Optional[int]:
        """``slot``'s row in this rank's cache, None where another data
        rank holds it."""
        row = slot - self._row0
        return row if 0 <= row < self._rows else None

    def _insert_slot(self, cache1: KVCache, row: int, slot: int,
                     plen: int) -> None:
        """The prompt's rows of ``cache1`` into the shared cache at
        ``slot`` (one copy per layer), and the slot's length on the
        device (a fill); on the data rank that holds the slot."""
        local = self._local(slot)
        if local is None:
            return
        for dst, src in zip(self.cache.k + self.cache.v, cache1.k + cache1.v):
            dst[local, :plen].copy_(src[row, :plen])
        self.cache.lengths[local].fill_(plen)

    # ---------------------------------------------------------- prefill

    def _prefill_one(self, tokens: torch.Tensor, cache1: KVCache, start: int,
                     fresh: bool = False):
        """One bucket of one prompt on its batch-1 cache, from ``start``
        (context-parallel where :func:`takes_cp` says so: the logits are
        then this data rank's chunk)."""
        cache1.reset(start)
        if takes_cp(self.mesh, tokens.shape[1], fresh):
            logits, _ = prefill_cp(self.model, tokens, cache1, self.mesh,
                                   self.dtype)
        else:
            logits, _ = forward(self.model, tokens, cache1, dtype=self.dtype,
                                fresh_prefill=fresh, tp=self.tp)
        return logits, cache1

    def _prefill_fresh_batch(self, tokens: torch.Tensor):
        """One batched fresh prefill of a row per prompt on the first rows
        of the bucket's scratch cache (``admit_parallel`` rows): the rows
        share one pass over the weights. Returns the logits and the whole
        scratch cache. The JAX scheduler pads every group to
        ``admit_parallel`` rows to keep one executable per bucket; the
        kernels here take any row count, so no padded row is computed."""
        rows, bucket = tokens.shape
        scratch = self._scratch.get(bucket)
        if scratch is None:
            scratch = self._scratch[bucket] = self._new_cache(
                self.admit_parallel, bucket)
        used = KVCache(k=[t[:rows] for t in scratch.k],
                       v=[t[:rows] for t in scratch.v],
                       lengths=scratch.lengths[:rows])
        used.reset(0)
        logits, _ = forward(self.model, tokens, used, dtype=self.dtype,
                            fresh_prefill=True, tp=self.tp)
        return logits, scratch

    # -------------------------------------------------------- admission

    def _start_admission(self) -> None:
        """Claim free slots for pending requests (one admission per free
        slot; all advance together, a bucket per step). With every slot
        taken, up to ``admit_parallel`` requests still prefill ahead."""
        while self.pending:
            claimed = {a.slot for a in self._admissions if a.slot is not None}
            slot = next(
                (s for s in range(self.max_batch)
                 if self.slots[s] is None and s not in claimed),
                None,
            )
            if slot is None:
                ahead = (sum(1 for a in self._admissions if a.slot is None)
                         + len(self._ready))
                if ahead >= self.admit_parallel:
                    return
            if self.prefix_cache is not None and self._admissions:
                # an admission in flight with this prompt's first block has
                # not cached its prefix yet: keep FIFO order and wait
                bs = self.prefix_cache.block_size
                head = list(self.pending[0].prompt[:bs])
                if any(list(a.req.prompt[:bs]) == head
                       for a in self._admissions):
                    return
            self._admit_one(slot)

    def _admit_one(self, slot: Optional[int]) -> None:
        req = self.pending.popleft()
        adm = _Admission(req=req, slot=slot)
        if self.prefix_cache is not None:
            done = self.prefix_cache.match(req.prompt)
            if done:  # match() never covers the whole prompt
                adm.cache1 = self._take_cache()
                write_rows(adm.cache1, 0,
                           *self.prefix_cache.gather(req.prompt, done))
                adm.done = done
        self._admissions.append(adm)

    def _advance_admission(self) -> None:
        """Run one prefill bucket of at most ``admit_parallel`` in-flight
        admissions (FIFO); fresh ones that fit one bucket go together
        through one batched prefill per bucket."""
        batch = self._admissions[: self.admit_parallel]
        grouped: Dict[int, List[_Admission]] = {}
        # on a data axis above 1 every admission runs alone, a fresh one
        # context-parallel where its bucket divides the axis (the JAX
        # package's rule under a mesh)
        batched = self.mesh is None or self.mesh.data == 1
        for adm in batch:
            n = len(adm.req.prompt)
            if batched and adm.done == 0 and adm.cache1 is None and (
                    n <= self.prompt_buckets[-1]):
                bucket = next(b for b in self.prompt_buckets if n <= b)
                grouped.setdefault(bucket, []).append(adm)
        in_group = set()
        for bucket, grp in grouped.items():
            self._prefill_group(grp, bucket)
            for adm in grp:
                in_group.add(id(adm))
                self._admissions.remove(adm)
        for adm in batch:
            if id(adm) not in in_group and self._advance_one(adm):
                self._admissions.remove(adm)

    def _prefill_group(self, grp: List[_Admission], bucket: int) -> None:
        padded = np.zeros((len(grp), bucket), dtype=np.int64)
        for i, adm in enumerate(grp):
            adm.last_len = len(adm.req.prompt)
            padded[i, : adm.last_len] = adm.req.prompt
        logits, scratch = self._prefill_fresh_batch(self._to_device(padded))
        self.stats["batched_admissions"] += len(grp)
        for i, adm in enumerate(grp):
            adm.last_logits = logits[i, adm.last_len - 1]
            adm.cache1, adm.row = scratch, i
            adm.done = adm.last_len
            self._finish_admission(adm)

    def _advance_one(self, adm: _Admission) -> bool:
        """Advance one bucket; True when the admission completed."""
        req = adm.req
        max_bucket = self.prompt_buckets[-1]
        chunk = req.prompt[adm.done: adm.done + max_bucket]
        adm.last_len = len(chunk)
        bucket = next(
            (b for b in self.prompt_buckets if adm.last_len <= b), max_bucket
        )
        padded = np.zeros((1, bucket), dtype=np.int64)
        padded[0, : adm.last_len] = chunk
        if adm.cache1 is None:
            adm.cache1 = self._take_cache()
        logits, adm.cache1 = self._prefill_one(
            self._to_device(padded), adm.cache1, adm.done,
            fresh=(adm.done == 0),
        )
        if takes_cp(self.mesh, bucket, adm.done == 0):
            # the row lies on the data rank whose chunk holds it
            adm.last_logits = cp_logits_row(logits, adm.last_len - 1,
                                            self.mesh)[0]
        else:
            # a copy: the bucket's logits need not live until the last one
            adm.last_logits = logits[0, adm.last_len - 1].clone()
        adm.done += adm.last_len
        if adm.done < len(req.prompt):
            return False  # more buckets to go; decode runs in between
        self._finish_admission(adm)
        return True

    def _finish_admission(self, adm: _Admission) -> None:
        """Prefill complete: the first token sampled on the device, then
        the slot filled, or the request parked ready (prefill-ahead)."""
        req = adm.req
        plen = len(req.prompt)
        if self.prefix_cache is not None:
            k, v = cache_rows(adm.cache1, adm.row, plen)
            self.prefix_cache.insert(req.prompt, k, v, plen)
        first = sample_next(
            adm.last_logits[None], _generator(self.device, req.seed),
            _temperature(req.temperature, self.device),
        )
        if adm.slot is not None:
            self._install(req, adm.cache1, adm.row, plen, first, adm.slot)
            self._give_cache(adm.cache1)
            return
        cache1 = adm.cache1
        if self._is_scratch(cache1):
            # a row of the scratch cache, which the next batched prefill
            # overwrites: the prompt's rows move to a cache of its own
            cache1 = self._take_cache()
            write_rows(cache1, 0, *cache_rows(adm.cache1, adm.row, plen))
        self._ready.append(_Ready(req=req, cache1=cache1, plen=plen,
                                  first=first))
        self.stats["prefill_ahead"] += 1

    def _install_ready(self) -> None:
        """Move parked prefill-ahead requests into free slots that no
        admission in flight has claimed."""
        while self._ready:
            claimed = {a.slot for a in self._admissions if a.slot is not None}
            slot = next(
                (s for s in range(self.max_batch)
                 if self.slots[s] is None and s not in claimed),
                None,
            )
            if slot is None:
                return
            r = self._ready.pop(0)
            self._install(r.req, r.cache1, 0, r.plen, r.first, slot)
            self._give_cache(r.cache1)

    def _install(self, req: Request, cache1: KVCache, row: int, plen: int,
                 first: torch.Tensor, slot: int) -> None:
        self._insert_slot(cache1, row, slot, plen)
        self.slots[slot] = req
        self._len[slot] = plen
        self._dispatched[slot] = 1  # the first token, sampled at prefill
        local = self._local(slot)
        if local is not None:
            self.decode.set_slot(local, first, req.temperature)
        # the first token stays on the device: it travels to the host as a
        # 1-token chunk, consumed in order with the decode chunks (the slot
        # may decode speculatively until then)
        toks = torch.zeros((1, self.max_batch), dtype=torch.int64,
                           device=self.device)
        toks[0, slot: slot + 1].copy_(first)
        pseudo = self._to_host(toks)
        pseudo.slots = [None] * self.max_batch
        pseudo.slots[slot] = req
        self._inflight.append(pseudo)

    # ----------------------------------------------------------- decode

    def _retire(self, slot: int, req: Optional[Request] = None) -> None:
        """Mark ``req`` (default: the slot's occupant) finished; the slot
        is freed only if it still holds ``req`` (a handoff may have given
        it to another already)."""
        req = req if req is not None else self.slots[slot]
        req.done = True
        self.finished[req.req_id] = req
        if self.slots[slot] is req:
            self.slots[slot] = None
            self._dispatched[slot] = 0

    def _handoff_exhausted(self) -> None:
        """Known-budget handoff: once a slot's dispatched tokens cover its
        occupant's ``max_new_tokens``, every further chunk for it is waste,
        so the next ready request takes the slot now, at the dispatch
        front. Its writes are queued after the chunks in flight, and each
        chunk's slot snapshot still sends the old request its tail."""
        for slot in range(self.max_batch):
            req = self.slots[slot]
            if req is None or not self._ready:
                continue
            if self._dispatched[slot] >= req.max_new_tokens:
                r = self._ready.pop(0)
                self._install(r.req, r.cache1, 0, r.plen, r.first, slot)
                self._give_cache(r.cache1)
                self.stats["handoffs"] += 1

    def _dispatch_chunk(self) -> None:
        """Enqueue one decode chunk on the device, with no wait for it (but
        on a data axis that the slots ride, the gather of every slot's
        tokens)."""
        active = [s is not None for s in self.slots]
        rows = slice(self._row0, self._row0 + self._rows)
        mine = active[rows]
        # a rank whose slots are all empty still steps: the gather below
        # waits for every data rank
        self.cache.max_len = max(
            (n for n, on in zip(self._len[rows], mine) if on), default=0)
        self.decode.set_active(mine)
        seed = self._chunk_idx
        if self._split:
            # each data rank draws its own slots' noise (JAX folds the
            # data index into the key)
            seed = seed * self.mesh.data + self.mesh.data_rank
        toks = self.decode.run(self.chunk, seed)
        if self._split:
            toks = all_gather_dim(toks, self.mesh.cp, 1)
        self._chunk_idx += 1
        for slot in range(self.max_batch):
            if active[slot]:
                self._dispatched[slot] += self.chunk
                self._len[slot] = min(self._len[slot] + self.chunk,
                                      self.max_seq - 1)
        self._inflight.append(self._to_host(toks))

    def _process_oldest(self) -> None:
        """Consume the oldest chunk in flight: stream its tokens, retire
        finished slots. Waits for that chunk's copy (the only wait on the
        device in the decode path)."""
        entry = self._inflight.popleft()
        t0 = time.perf_counter()
        if entry.event is not None:
            entry.event.synchronize()
        arr = entry.host.numpy()
        self.stats["sync_wait_s"] += time.perf_counter() - t0

        for slot in range(self.max_batch):
            req = entry.slots[slot]
            if req is None or req.done:
                # empty at dispatch, or retired by an earlier chunk: this
                # column is speculative
                continue
            remaining = req.max_new_tokens - len(req.output)
            # the seq-cap term is 0 only for the 1-token chunk of a
            # (max_seq - 1)-token prompt, whose token is in hand: floored
            # at 1, every admitted request yields a token
            budget = min(
                remaining,
                self.chunk,
                max(1, self.max_seq - len(req.prompt) - len(req.output) - 1),
            )
            new = arr[:budget, slot].tolist()
            if req.eos_token_id is not None and req.eos_token_id in new:
                new = new[: new.index(req.eos_token_id) + 1]
            req.output.extend(new)
            if req.stream_callback:
                for t in new:
                    req.stream_callback(req.req_id, t)
            hit_eos = req.eos_token_id is not None and req.eos_token_id in new
            out_of_budget = len(req.output) >= req.max_new_tokens
            out_of_seq = len(req.prompt) + len(req.output) + 1 >= self.max_seq
            if hit_eos or out_of_budget or out_of_seq:
                self._retire(slot, req)
        if entry.event is not None:
            self._host_bufs[tuple(entry.host.shape)].append(entry.host)

    @torch.inference_mode()
    def step(self) -> None:
        """Advance one prefill bucket (if admitting), dispatch one decode
        chunk, and consume results ``depth - 1`` chunks behind the
        dispatch front."""
        self.stats["steps"] += 1
        t0 = time.perf_counter()
        self._install_ready()
        self._start_admission()
        self._advance_admission()
        # an admission that just completed frees the machinery for the
        # next pending request (its first bucket runs next step)
        self._start_admission()
        self._handoff_exhausted()
        t1 = time.perf_counter()
        self.stats["admit_s"] += t1 - t0
        if self.num_active:
            self._dispatch_chunk()
            self.stats["chunks"] += 1
            self.stats["dispatch_s"] += time.perf_counter() - t1
        elif self._inflight:
            # nothing to dispatch: drain a chunk so retirements land
            self._process_oldest()
        while len(self._inflight) >= self.depth:
            self._process_oldest()

    def run(self) -> Dict[int, List[int]]:
        """Drive until every submitted request completes."""
        while (self.pending or self.num_active or self._admissions
               or self._ready or self._inflight):
            self.step()
        return {rid: r.output for rid, r in self.finished.items()}
