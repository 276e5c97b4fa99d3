"""Generation: bucketed prefill, then chunked decode on the device.

Port of ``vptq_tpu/serving/generate.py`` for one sequence on one device
(no prefix cache, no mesh). The JAX package runs each decode chunk as
one ``lax.scan`` inside one jit. Here, on a CUDA device, each decode
step is captured once as a CUDA graph (:class:`DecodeGraphs`, one graph
per number of live cache blocks and per greedy or sampled step) and
replayed for the chunk: the host enqueues one graph a token, and reads
the chunk's tokens once, at its end. On the CPU, which the caller asks
for explicitly, a chunk is :func:`decode_loop`, the eager loop of
``forward`` calls that the graphs are held against.
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

__all__ = [
    "DecodeGraphs", "Generator", "decode_loop", "decode_plan", "sample_next",
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
):
    """Generate ``steps`` tokens on the device, one eager ``forward`` a
    step. Returns ((steps, B), cache); each step's (B, V) logits are
    appended to ``logits`` when it is given."""
    temp = _temperature(temperature, first_token.device)
    tok = first_token
    out = []
    for _ in range(steps):
        step_logits, cache = forward(model, tok[:, None], cache, dtype=dtype)
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


class DecodeGraphs:
    """The decode step of one model and cache as CUDA graphs, replayed.

    A step is ``forward`` at one token, then sampling, then the token
    written to the input of the next step and to a buffer of the chunk's
    tokens on the card; ``forward`` advances the cache's lengths in
    place. Its shapes depend only on the live cache positions the step
    reads (``llama.attended``: whole 256-position blocks), so one graph
    per such count and per greedy or sampled step serves every step; each
    is captured at its first use, after one eager step on the capture
    stream that builds any kernel library and sets the kernels'
    attributes, neither of which may happen inside a capture. That eager
    step is a real step of the chunk. All graphs share one memory pool.

    The buffers a graph reads and writes stay at fixed addresses: the
    input token, the cache and its lengths, the temperature (a device
    scalar), the step counter and the token buffer. The sampled graphs
    draw from one ``torch.Generator`` registered with each, re-seeded for
    every chunk. A replay runs no Python, so the kernel wrappers' launch
    counts are recorded at capture and added on every replay. A capture
    or a replay that fails raises: nothing falls back to the eager loop.
    """

    def __init__(self, model: Model, cache: KVCache, dtype):
        device = cache.lengths.device
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA cache, not {device}")
        batch, max_seq = cache.k[0].shape[:2]
        self.model, self.cache, self.dtype = model, cache, dtype
        self.max_seq = max_seq
        self.tok = torch.zeros(batch, dtype=torch.int64, device=device)
        # the chunk's tokens, row = step of the chunk (a chunk is shorter
        # than max_seq)
        self.tokens = torch.zeros(
            (max_seq, batch), dtype=torch.int64, device=device
        )
        self.step_idx = torch.zeros(1, dtype=torch.int64, device=device)
        self.temperature = torch.ones((), dtype=torch.float32, device=device)
        self.generator = torch.Generator(device=device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        # (attended positions, sampled) -> (graph, its logits, launches a
        # replay makes per kernel wrapper)
        self.captured: Dict[tuple, tuple] = {}
        self.capture_s: Dict[tuple, float] = {}
        self.sampled = False
        self.logits: Optional[torch.Tensor] = None

    def begin(self, first: torch.Tensor, temperature: float, seed: int):
        """Start a chunk at token ``first`` (B,) on the card: the
        sampled graphs' generator re-seeded with ``seed``."""
        self.sampled = temperature > 0
        if self.sampled:
            self.temperature.fill_(temperature)
            self.generator.manual_seed(seed)
        self.tok.copy_(first)
        self.step_idx.zero_()

    def _step(self) -> torch.Tensor:
        logits, _ = forward(
            self.model, self.tok[:, None], self.cache, dtype=self.dtype
        )
        nxt = sample_next(
            logits[:, 0], self.generator,
            self.temperature if self.sampled else None,
        )
        self.tok.copy_(nxt)
        self.tokens.index_copy_(0, self.step_idx, nxt[None])
        self.step_idx.add_(1)
        return logits[:, 0]

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
        if self.sampled:
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
        key = attended(self.cache.max_len, 1, self.max_seq), self.sampled
        entry = self.captured.get(key)
        if entry is None:
            self._capture(key)
            return self.logits
        graph, logits, launches = entry
        graph.replay()
        self.cache.max_len += 1
        for f, n in launches:
            f.launches += n
        self.logits = logits
        return logits

    def run(self, first: torch.Tensor, steps: int, temperature: float,
            seed: int) -> torch.Tensor:
        """``steps`` tokens from ``first``: (steps, B) on the card."""
        if not 0 < steps <= self.max_seq:
            raise ValueError(f"a chunk of {steps} steps")
        self.begin(first, temperature, seed)
        for _ in range(steps):
            self.step()
        return self.tokens[:steps]

    def pool_bytes(self) -> int:
        """Bytes the graphs' shared memory pool holds on the card."""
        pool = self.pool
        return sum(
            s["total_size"] for s in torch.cuda.memory_snapshot()
            if tuple(s.get("segment_pool_id", ())) == tuple(pool)
        )


def _pad_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


class Generator:
    """Generation for one sequence at a time, on one persistent cache
    (allocated once at ``max_seq``; each request resets its lengths). On
    a CUDA device every decode chunk runs through :class:`DecodeGraphs`."""

    def __init__(
        self,
        model: Model,
        max_seq: int = 2048,
        dtype=torch.bfloat16,
        prompt_buckets: Sequence[int] = (128, 512, 2048),
    ):
        self.model = model
        self.max_seq = max_seq
        self.dtype = dtype
        self.device = model.embed_tokens.device
        self.prompt_buckets = [b for b in prompt_buckets if b <= max_seq]
        if not self.prompt_buckets:
            self.prompt_buckets = [max_seq]
        self.cache = init_cache(
            model.cfg, 1, max_seq, dtype, self.device
        )
        self.graphs = (
            DecodeGraphs(model, self.cache, dtype)
            if self.device.type == "cuda" else None
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
        while done < plen:
            chunk = prompt[done: done + max_bucket]
            last_len = len(chunk)
            bucket = _pad_bucket(last_len, self.prompt_buckets)
            padded = np.zeros(bucket, np.int64)
            padded[:last_len] = chunk
            logits, cache = forward(
                self.model,
                torch.from_numpy(padded)[None, :].to(self.device),
                cache,
                dtype=self.dtype,
                fresh_prefill=(done == 0),
            )
            done += last_len
            cache.reset(done)
        last_logits = logits[:, last_len - 1]

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
