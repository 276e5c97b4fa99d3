"""Generation: bucketed prefill, then chunked decode on the device.

Port of ``vptq_tpu/serving/generate.py`` for one sequence, with its
prefix cache, and the batched decode step of its scheduler
(:class:`BatchedDecode`); on one device, or as one rank of a mesh
(``mesh=``: every rank runs the same calls on its shard,
``parallel/tp.py``; a fresh prefill on a data axis above 1 splits its
prompt over it, ``prefill_cp``). The JAX package runs each decode
chunk as one ``lax.scan`` inside one jit. Here, on a CUDA device, each
decode step is captured once as a CUDA graph (:class:`DecodeGraphs`, one
graph per number of live cache blocks and per greedy or sampled step)
and replayed for the chunk: the host enqueues one graph a token, and
reads the chunk's tokens once, at its end. On the CPU, which the caller
asks for explicitly, a chunk is :func:`decode_loop`, the eager loop of
``forward`` calls that the graphs are held against. Under a mesh the
step holds the model axis's collectives: it is captured when the group's
backend can be (NCCL), and runs eagerly on gloo, whose collectives run on
the host; ``decode_mode`` says which.
"""

from __future__ import annotations

import importlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vptq_tpu_torch.models.llama import (
    _DECODE_BLOCK,
    KVCache,
    Model,
    attended,
    forward,
    init_cache,
)
from vptq_tpu_torch.ops import _build
from vptq_tpu_torch.parallel.tp import cp_logits_row, prefill_cp

__all__ = [
    "BatchedDecode", "DecodeGraphs", "Generator", "decode_loop",
    "decode_plan", "sample_next", "sample_slots", "takes_cp",
]


def sample_next(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature: Optional[torch.Tensor],
) -> torch.Tensor:
    """Greedy (``temperature`` None) or temperature sampling for one step.

    ``logits`` (B, V) → (B,) int64 tokens. ``temperature`` is a 0-d f32
    tensor on the logits' device, so that a captured step reads it where
    it lies. Sampling is Gumbel-max, as ``jax.random.categorical`` does;
    the draws come from ``generator`` and differ from JAX's for the same
    seed.
    """
    if temperature is None:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(
        logits.shape, generator=generator, device=logits.device,
        dtype=torch.float32,
    )
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits / temperature + gumbel, dim=-1)


def _temperature(value: float, device) -> Optional[torch.Tensor]:
    """``value`` as the 0-d tensor :func:`sample_next` takes (None:
    greedy), filled in on the device."""
    if value <= 0:
        return None
    return torch.full((), value, dtype=torch.float32, device=device)


def decode_loop(
    model: Model,
    first_token: torch.Tensor,  # (B,) int64
    cache: KVCache,
    generator: torch.Generator,
    temperature: float,
    *,
    steps: int,
    dtype=torch.bfloat16,
    logits: Optional[List[torch.Tensor]] = None,
    tp=None,
):
    """Generate ``steps`` tokens on the device, one eager ``forward`` a
    step. Returns ((steps, B), cache); each step's (B, V) logits are
    appended to ``logits`` when it is given. ``tp``: this rank's shard
    (``forward``'s)."""
    temp = _temperature(temperature, first_token.device)
    tok = first_token
    out = []
    for _ in range(steps):
        step_logits, cache = forward(model, tok[:, None], cache, dtype=dtype,
                                     tp=tp)
        tok = sample_next(step_logits[:, 0], generator, temp)
        out.append(tok)
        if logits is not None:
            logits.append(step_logits[:, 0])
    return torch.stack(out), cache


def decode_plan(max_len: int, steps: int, max_seq: int) -> List[int]:
    """The live 256-position block counts of ``steps`` decode steps from
    ``max_len`` cached tokens on a cache of ``max_seq`` whole blocks,
    ``(offset + 256) // 256`` at each step's offset: the graphs a chunk
    replays in turn, known on the host."""
    return [attended(n, 1, max_seq) // _DECODE_BLOCK
            for n in range(max_len, max_len + steps)]


def _counted() -> Tuple:
    """The wrapper of every kernel of the port (``_build.SOURCES``: each
    module ``ops/<name>.py`` holds the wrapper ``<name>``, which counts
    its launches in ``<name>.launches``)."""
    return tuple(
        getattr(importlib.import_module(f"vptq_tpu_torch.ops.{n}"), n)
        for n in _build.SOURCES
    )


class _Graphs:
    """A decode step of one model and cache as CUDA graphs, replayed.

    A step is ``forward`` at one token per sequence, then sampling, then
    the tokens written to the input of the next step and to a buffer of
    the chunk's tokens on the card; ``forward`` advances the cache's
    lengths in place. Its shapes depend only on the live cache positions
    the step reads (``llama.attended``: whole 256-position blocks, from
    the host's ``cache.max_len``), so one graph per such count (and per
    what else :meth:`_key` names) serves every step; each is captured at
    its first use, after one eager step on the capture stream that builds
    any kernel library and sets the kernels' attributes, neither of which
    may happen inside a capture. That eager step is a real step of the
    chunk. All graphs share one memory pool.

    The buffers a graph reads and writes stay at fixed addresses. The
    sampled graphs draw from one ``torch.Generator`` registered with
    each, re-seeded for every chunk. A replay runs no Python, so the
    kernel wrappers' launch counts are recorded at capture and added on
    every replay. A capture or a replay that fails raises: nothing falls
    back to the eager loop. Under tensor parallelism (``tp``) the step
    holds the model axis's collectives, which every rank captures and
    replays in the same order; only a group whose collectives can be
    captured (NCCL, ``parallel.distributed.capturable``) takes graphs.
    """

    def __init__(self, model: Model, cache: KVCache, dtype, rows: int,
                 tp=None):
        device = cache.lengths.device
        batch, max_seq = cache.k[0].shape[:2]
        self.model, self.cache, self.dtype = model, cache, dtype
        self.tp = tp
        self.max_seq = max_seq
        self.tok = torch.zeros(batch, dtype=torch.int64, device=device)
        # the chunk's tokens, row = step of the chunk
        self.tokens = torch.zeros(
            (rows, batch), dtype=torch.int64, device=device
        )
        self.step_idx = torch.zeros(1, dtype=torch.int64, device=device)
        self.generator = torch.Generator(device=device)
        # (key) -> (graph, its logits, launches a replay makes per kernel
        # wrapper)
        self.captured: Dict[tuple, tuple] = {}
        self.capture_s: Dict[tuple, float] = {}
        self.logits: Optional[torch.Tensor] = None
        if device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device)

    def _key(self) -> tuple:
        raise NotImplementedError

    def _sampled(self) -> bool:
        raise NotImplementedError

    def _step(self) -> torch.Tensor:
        raise NotImplementedError

    def _advance(self) -> None:
        """The host's count after a replayed step (the replay runs no
        Python)."""
        self.cache.max_len += 1

    def _capture(self, key: tuple) -> None:
        t0 = time.perf_counter()
        before = self.cache.max_len
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            self.logits = self._step()
        torch.cuda.current_stream().wait_stream(self.stream)
        self.logits.record_stream(torch.cuda.current_stream())
        kernels = _counted()
        counts = [f.launches for f in kernels]
        graph = torch.cuda.CUDAGraph()
        if self._sampled():
            graph.register_generator_state(self.generator)
        # the capture runs nothing: the host count goes back to what the
        # eager step started from (the key's shapes), and the captured
        # forward leaves it where the eager step did
        self.cache.max_len = before
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            logits = self._step()
        launches = []
        for f, n in zip(kernels, counts):
            if f.launches != n:
                launches.append((f, f.launches - n))
            f.launches = n
        self.captured[key] = (graph, logits, tuple(launches))
        self.capture_s[key] = time.perf_counter() - t0

    def step(self) -> torch.Tensor:
        """One decode step: its graph replayed, or captured first (after
        a real eager step). Returns the step's (B, V) logits, valid until
        the next step."""
        key = self._key()
        entry = self.captured.get(key)
        if entry is None:
            self._capture(key)
            return self.logits
        graph, logits, launches = entry
        graph.replay()
        self._advance()
        for f, n in launches:
            f.launches += n
        self.logits = logits
        return logits

    def pool_bytes(self) -> int:
        """Bytes the graphs' shared memory pool holds on the card."""
        pool = self.pool
        return sum(
            s["total_size"] for s in torch.cuda.memory_snapshot()
            if tuple(s.get("segment_pool_id", ())) == tuple(pool)
        )


class DecodeGraphs(_Graphs):
    """The decode step of one sequence's cache (batch 1, or a batch whose
    sequences all decode) as CUDA graphs: one per live 256-position block
    count and per greedy or sampled step. The temperature is a device
    scalar; the step counter and the token buffer are the chunk's."""

    def __init__(self, model: Model, cache: KVCache, dtype, tp=None):
        device = cache.lengths.device
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA cache, not {device}")
        # a chunk is shorter than max_seq
        super().__init__(model, cache, dtype, rows=cache.k[0].shape[1],
                         tp=tp)
        self.temperature = torch.ones((), dtype=torch.float32, device=device)
        self.sampled = False

    def begin(self, first: torch.Tensor, temperature: float, seed: int):
        """Start a chunk at token ``first`` (B,) on the card: the
        sampled graphs' generator re-seeded with ``seed``."""
        self.sampled = temperature > 0
        if self.sampled:
            self.temperature.fill_(temperature)
            self.generator.manual_seed(seed)
        self.tok.copy_(first)
        self.step_idx.zero_()

    def _key(self) -> tuple:
        return attended(self.cache.max_len, 1, self.max_seq), self.sampled

    def _sampled(self) -> bool:
        return self.sampled

    def _step(self) -> torch.Tensor:
        logits, _ = forward(
            self.model, self.tok[:, None], self.cache, dtype=self.dtype,
            tp=self.tp,
        )
        nxt = sample_next(
            logits[:, 0], self.generator,
            self.temperature if self.sampled else None,
        )
        self.tok.copy_(nxt)
        self.tokens.index_copy_(0, self.step_idx, nxt[None])
        self.step_idx.add_(1)
        return logits[:, 0]

    def run(self, first: torch.Tensor, steps: int, temperature: float,
            seed: int) -> torch.Tensor:
        """``steps`` tokens from ``first``: (steps, B) on the card."""
        if not 0 < steps <= self.max_seq:
            raise ValueError(f"a chunk of {steps} steps")
        self.begin(first, temperature, seed)
        for _ in range(steps):
            self.step()
        return self.tokens[:steps]


def sample_slots(
    logits: torch.Tensor,  # (B, V)
    generator: torch.Generator,
    temps: torch.Tensor,  # (B,) f32 on the logits' device, 0: greedy
) -> torch.Tensor:
    """Per-slot greedy or temperature sampling, (B,) int64: a slot at
    temperature 0 takes ``argmax(logits)`` bit for bit, whatever its
    neighbours draw; the others take the Gumbel-max of ``logits / t``."""
    u = torch.rand(
        logits.shape, generator=generator, device=logits.device,
        dtype=torch.float32,
    )
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(
        logits / temps.clamp(min=1e-6)[:, None] + gumbel, dim=-1
    )
    return torch.where(temps > 0, sampled, torch.argmax(logits, dim=-1))


class BatchedDecode(_Graphs):
    """The decode step of every slot of a shared cache: the port of the
    JAX scheduler's ``_batched_decode`` step.

    All ``B`` slots advance together; only the active ones keep their
    advanced length (an inactive slot computes into its own rows, masked
    by its length and rewritten on reuse) and their new token (an
    inactive slot keeps its last). Lengths stop at ``max_seq - 1``: a
    slot that far has no token left to give (the scheduler retires a
    request once prompt and output fill ``max_seq - 1``, so its last
    counted step writes at ``max_seq - 3``), and every write of a
    speculative step past its budget stays inside the cache. Sampling is
    per slot from the (B,) temperatures (:func:`sample_slots`). The last
    tokens, ``active``, the temperatures, the step counter and the token
    buffer sit at fixed addresses. On a CUDA device each step is a graph
    per live block count, keyed on the host's ``cache.max_len``, which
    the caller sets to the longest active slot before a chunk; on the
    CPU, and under a tensor-parallel group whose collectives cannot be
    captured (:func:`graphs_for`), the same step runs eagerly.
    """

    def __init__(self, model: Model, cache: KVCache, dtype, chunk: int,
                 tp=None):
        super().__init__(model, cache, dtype, rows=chunk, tp=tp)
        device = cache.lengths.device
        batch = cache.k[0].shape[0]
        self.graphed = graphs_for(device, tp)
        self.active = torch.zeros(batch, dtype=torch.bool, device=device)
        self.temps = torch.zeros(batch, dtype=torch.float32, device=device)
        self._active_host = [False] * batch
        self._steps = 0

    def set_active(self, active: Sequence[bool]) -> None:
        """The slots that decode, written on the device slot by slot (a
        fill each; no copy from the host)."""
        for slot, on in enumerate(active):
            if on != self._active_host[slot]:
                self.active[slot].fill_(on)
                self._active_host[slot] = on

    def set_slot(self, slot: int, first: torch.Tensor, temperature: float):
        """A new occupant of ``slot``: its first token (a (1,) tensor on
        the device) and its temperature."""
        self.tok[slot: slot + 1].copy_(first)
        self.temps[slot].fill_(temperature)

    def _key(self) -> tuple:
        return (attended(self.cache.max_len, 1, self.max_seq),)

    def _sampled(self) -> bool:
        return True

    def _advance(self) -> None:
        self.cache.max_len = min(self.cache.max_len + 1, self.max_seq - 1)

    def _step(self) -> torch.Tensor:
        cache = self.cache
        logits, _ = forward(
            self.model, self.tok[:, None], cache, dtype=self.dtype,
            tp=self.tp,
        )
        # forward advanced every slot by one
        cache.lengths.sub_((~self.active).to(torch.int64))
        cache.lengths.clamp_(max=self.max_seq - 1)
        cache.max_len = min(cache.max_len, self.max_seq - 1)
        sampled = sample_slots(logits[:, 0], self.generator, self.temps)
        nxt = torch.where(self.active, sampled, self.tok)
        self.tok.copy_(nxt)
        self.tokens.index_copy_(0, self.step_idx, nxt[None])
        self.step_idx.add_(1)
        return logits[:, 0]

    def begin(self, seed: int) -> None:
        """Start a chunk: the step counter to 0, the generator re-seeded."""
        self.generator.manual_seed(seed)
        self.step_idx.zero_()
        self._steps = 0

    def _count(self) -> None:
        # the step counter lives on the device; the host's twin keeps a
        # chunk inside its token buffer
        if self._steps >= self.tokens.shape[0]:
            raise ValueError(
                f"a chunk of more than {self.tokens.shape[0]} steps")
        self._steps += 1

    def step(self) -> torch.Tensor:
        self._count()
        if self.graphed:
            return super().step()
        self.logits = self._step()
        return self.logits

    def eager_step(self) -> torch.Tensor:
        """The same step run eagerly, outside any graph (what the graphs
        are held against)."""
        self._count()
        self.logits = self._step()
        return self.logits

    def run(self, steps: int, seed: int) -> torch.Tensor:
        """``steps`` steps from the slots' last tokens: (steps, B) on the
        device."""
        self.begin(seed)
        for _ in range(steps):
            self.step()
        return self.tokens[:steps]


def write_rows(cache: KVCache, slot: int, k: torch.Tensor, v: torch.Tensor):
    """(layers, 1, n, kv, hd) K/V rows into sequence ``slot`` of ``cache``
    from position 0, one copy per layer (its length is the caller's)."""
    n = k.shape[2]
    for i in range(len(cache.k)):
        cache.k[i][slot, :n].copy_(k[i, 0])
        cache.v[i][slot, :n].copy_(v[i, 0])


def cache_rows(cache: KVCache, slot: int, n: int):
    """The first ``n`` K/V rows of sequence ``slot``: (layers, 1, n, kv, hd)
    each, the layout :class:`PrefixCache` stores."""
    return (
        torch.stack([b[slot: slot + 1, :n] for b in cache.k]),
        torch.stack([b[slot: slot + 1, :n] for b in cache.v]),
    )


def _pad_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def serving_tp(mesh):
    """The model axis a server's forward calls take under ``mesh`` (None
    without one)."""
    return None if mesh is None else mesh.tp


def takes_cp(mesh, bucket: int, fresh: bool) -> bool:
    """The JAX package's rule for a server's prefill under ``mesh``: a
    fresh chunk whose padded length divides the data axis (above 1) runs
    context-parallel (``parallel.tp.prefill_cp``); every other chunk runs
    on the model axis alone, every data rank the whole chunk."""
    return (fresh and mesh is not None and mesh.data > 1
            and bucket % mesh.data == 0)


def graphs_for(device: torch.device, tp) -> bool:
    """Whether decode steps run as CUDA graphs: on a CUDA device, and
    under a model axis ``tp`` only when its collectives can be captured
    (NCCL); gloo's step runs eagerly."""
    from vptq_tpu_torch.parallel.distributed import capturable

    if device.type != "cuda":
        return False
    return tp is None or capturable(tp.group)


class Generator:
    """Generation for one sequence at a time, on one persistent cache
    (allocated once at ``max_seq``; each request resets its lengths). On
    a CUDA device every decode chunk runs through :class:`DecodeGraphs`.
    With a ``prefix_cache`` (``serving.prefix_cache.PrefixCache``) the
    longest cached prefix of a prompt is copied into the cache (one copy
    per layer) and only the rest is prefilled; every prompt's full blocks
    are cached after its prefill.

    ``mesh`` (``parallel/mesh.py``): ``model`` is this rank's shard
    (``load_model(mesh=)``), and every rank of the mesh calls
    :meth:`generate` with the same arguments: the same gathered logits and
    the same seeds give every rank the same tokens, so that each takes the
    same host decisions (buckets, EOS, budget) and none waits alone in a
    collective. On a data axis above 1 a fresh prompt whose padded bucket
    divides it is prefilled context-parallel (:func:`takes_cp`), and the
    row that samples the first token comes from the data rank whose chunk
    holds it; the cache of the one sequence is whole on every data rank,
    each of which then decodes it (JAX's ``batch_axis`` is None at batch
    1). ``decode_mode``:
    "graphed" (:class:`DecodeGraphs`: a CUDA device, and under a mesh a
    group whose collectives can be captured) or "eager"
    (:func:`decode_loop`)."""

    def __init__(
        self,
        model: Model,
        max_seq: int = 2048,
        dtype=torch.bfloat16,
        prompt_buckets: Sequence[int] = (128, 512, 2048),
        prefix_cache=None,
        mesh=None,
    ):
        self.model = model
        self.max_seq = max_seq
        self.dtype = dtype
        self.prefix_cache = prefix_cache
        self.mesh = mesh
        self.tp = serving_tp(mesh)
        self.device = model.embed_tokens.device
        self.prompt_buckets = [b for b in prompt_buckets if b <= max_seq]
        if not self.prompt_buckets:
            self.prompt_buckets = [max_seq]
        self.cache = init_cache(
            model.cfg, 1, max_seq, dtype, self.device,
            tp_size=1 if mesh is None else mesh.model,
        )
        graphed = graphs_for(self.device, self.tp)
        self.decode_mode = "graphed" if graphed else "eager"
        self.graphs = (
            DecodeGraphs(model, self.cache, dtype, tp=self.tp)
            if graphed else None
        )

    @torch.inference_mode()
    def generate(
        self,
        prompt_tokens: Sequence[int] | np.ndarray,
        max_new_tokens: int = 128,
        eos_token_id: Optional[int] = None,
        temperature: float = 0.0,
        seed: int = 0,
        stream_callback=None,
        chunk_size: int = 32,
    ) -> List[int]:
        """Generate tokens; the host reads them once per ``chunk_size``."""
        prompt = np.asarray(prompt_tokens, dtype=np.int64)
        if prompt.ndim != 1:
            raise ValueError("prompt must be 1-D")
        if prompt.size == 0:
            raise ValueError("prompt must contain at least one token")
        plen = len(prompt)
        if plen >= self.max_seq:
            raise ValueError(f"prompt length {plen} >= max_seq {self.max_seq}")

        cache = self.cache
        cache.reset(0)
        # Prefill in bucket-sized chunks, each right-padded into its
        # bucket; the cache length is rewound to the true length after
        # each chunk, so padded K/V rows are never attended to and the
        # next chunk or token overwrites them.
        max_bucket = self.prompt_buckets[-1]
        done = 0
        last_len = 0
        logits = None
        cp = False
        if self.prefix_cache is not None:
            done = self.prefix_cache.match(prompt)
            if done:
                write_rows(cache, 0, *self.prefix_cache.gather(prompt, done))
                cache.reset(done)
        while done < plen:
            chunk = prompt[done: done + max_bucket]
            last_len = len(chunk)
            bucket = _pad_bucket(last_len, self.prompt_buckets)
            padded = np.zeros(bucket, np.int64)
            padded[:last_len] = chunk
            tokens = torch.from_numpy(padded)[None, :].to(self.device)
            cp = takes_cp(self.mesh, bucket, done == 0)
            if cp:
                logits, cache = prefill_cp(self.model, tokens, cache,
                                           self.mesh, self.dtype)
            else:
                logits, cache = forward(
                    self.model, tokens, cache, dtype=self.dtype,
                    fresh_prefill=(done == 0), tp=self.tp,
                )
            done += last_len
            cache.reset(done)
        last_logits = (cp_logits_row(logits, last_len - 1, self.mesh) if cp
                       else logits[:, last_len - 1])
        if self.prefix_cache is not None:
            self.prefix_cache.insert(prompt, *cache_rows(cache, 0, plen), plen)

        first = sample_next(
            last_logits, _generator(self.device, seed),
            _temperature(temperature, self.device),
        )
        out_tokens = [int(first[0])]
        if stream_callback is not None:
            stream_callback(out_tokens[0])
        if eos_token_id is not None and out_tokens[0] == eos_token_id:
            return out_tokens

        budget = min(max_new_tokens - 1, self.max_seq - plen - 1)
        done = 0
        chunk_idx = 0
        while done < budget:
            steps = min(chunk_size, budget - done)
            if self.graphs is not None:
                toks = self.graphs.run(
                    first, steps, temperature, seed + 1 + chunk_idx
                )
            else:
                toks, cache = decode_loop(
                    self.model,
                    first,
                    cache,
                    _generator(self.device, seed + 1 + chunk_idx),
                    temperature,
                    steps=steps,
                    dtype=self.dtype,
                    tp=self.tp,
                )
            arr = toks[:, 0].tolist()
            stop = None
            if eos_token_id is not None and eos_token_id in arr:
                stop = arr.index(eos_token_id)
                arr = arr[: stop + 1]
            out_tokens.extend(arr)
            if stream_callback is not None:
                for t in arr:
                    stream_callback(t)
            if stop is not None:
                break
            first = toks[-1]
            done += steps
            chunk_idx += 1
        return out_tokens
