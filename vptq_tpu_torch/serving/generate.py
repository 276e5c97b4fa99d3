"""Generation: bucketed prefill, then chunked decode on the device.

Port of ``vptq_tpu/serving/generate.py`` for one sequence on one device
(no prefix cache, no mesh). The JAX package runs each decode chunk as
one ``lax.scan`` inside one jit; here a chunk is a Python loop of
``forward`` calls whose sampled tokens stay on the device, so the host
enqueues a whole chunk and reads its tokens once, at the chunk's end.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from vptq_tpu_torch.models.llama import KVCache, Model, forward, init_cache

__all__ = ["Generator", "decode_loop", "sample_next"]


def sample_next(
    logits: torch.Tensor, generator: torch.Generator, temperature: float
) -> torch.Tensor:
    """Greedy (temperature 0) or temperature sampling for one step.

    ``logits`` (B, V) → (B,) int64 tokens. Sampling is Gumbel-max, as
    ``jax.random.categorical`` does; the draws come from ``generator``
    and differ from JAX's for the same seed.
    """
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(
        logits.shape, generator=generator, device=logits.device,
        dtype=torch.float32,
    )
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits / temperature + gumbel, dim=-1)


def decode_loop(
    model: Model,
    first_token: torch.Tensor,  # (B,) int64
    cache: KVCache,
    generator: torch.Generator,
    temperature: float,
    *,
    steps: int,
    dtype=torch.bfloat16,
):
    """Generate ``steps`` tokens on the device. Returns ((steps, B), cache)."""
    tok = first_token
    out = []
    for _ in range(steps):
        logits, cache = forward(model, tok[:, None], cache, dtype=dtype)
        tok = sample_next(logits[:, 0], generator, temperature)
        out.append(tok)
    return torch.stack(out), cache


def _pad_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


class Generator:
    """Generation for one sequence at a time."""

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

        cache = init_cache(
            self.model.cfg, 1, self.max_seq, self.dtype, self.device
        )
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
            cache.lengths = [done]
        last_logits = logits[:, last_len - 1]

        if temperature > 0:
            first = sample_next(
                last_logits, _generator(self.device, seed), temperature
            )
        else:
            first = torch.argmax(last_logits, dim=-1)
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
