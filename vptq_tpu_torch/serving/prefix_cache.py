"""Prefix KV cache: reuse shared prompt prefixes across requests.

Port of ``vptq_tpu/serving/prefix_cache.py``. Prompts are split into
``block_size``-token blocks; each FULL block is keyed by (parent key,
block tokens), so a block is reused only when its whole left context
matches. A block holds the (layers, block_size, kv_heads, dim) K and V
rows its prefill wrote, on the cache's device (K and V may differ in
width: MLA caches a latent of kv_lora + rope dims as K, kv_lora as V, so
each is counted apart), and the blocks are evicted least recently used
first against a byte budget. A lookup
concatenates the longest chain of cached blocks; the caller writes it
into its cache and prefills only the rest of the prompt. The partial
last block is never cached.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["PrefixCache"]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class PrefixCache:
    def __init__(self, block_size: int = 64, capacity_bytes: int = 1 << 30):
        self.block_size = block_size
        self.capacity_bytes = capacity_bytes
        # key -> (k_block, v_block), each (layers, block, kv, dim)
        self._store: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def _keys_for(self, tokens: np.ndarray) -> List[Tuple]:
        """Chained keys of each full block of ``tokens``."""
        keys: List[Tuple] = []
        parent: Tuple = ()
        bs = self.block_size
        for b in range(len(tokens) // bs):
            key = (parent, tuple(int(t) for t in tokens[b * bs: (b + 1) * bs]))
            keys.append(key)
            parent = key
        return keys

    def match(self, tokens: Sequence[int]) -> int:
        """Longest cached prefix length (a multiple of ``block_size``),
        never the whole prompt: the caller must still prefill at least one
        token to get the next token's logits."""
        tokens = np.asarray(tokens)
        n = 0
        for key in self._keys_for(tokens):
            if key not in self._store:
                break
            self._store.move_to_end(key)  # LRU touch
            n += self.block_size
        if n >= len(tokens):
            n = max(0, (len(tokens) - 1) // self.block_size * self.block_size)
        if n:
            self.hits += 1
        else:
            self.misses += 1
        return n

    def gather(self, tokens: Sequence[int], n: int):
        """(k, v) rows of the first ``n`` cached tokens, each (layers, 1,
        n, kv_heads, dim); None for ``n`` 0."""
        if n == 0:
            return None
        keys = self._keys_for(np.asarray(tokens)[:n])
        blocks = [self._store[key] for key in keys]
        k = torch.cat([b[0] for b in blocks], dim=1)[:, None]
        v = torch.cat([b[1] for b in blocks], dim=1)[:, None]
        return k, v

    def insert(
        self,
        tokens: Sequence[int],
        k: torch.Tensor,  # (layers, 1, >= plen, kv, hd)
        v: torch.Tensor,
        plen: Optional[int] = None,
    ) -> None:
        """Cache the K/V rows of every full block of ``tokens[:plen]``."""
        tokens = np.asarray(tokens)
        plen = plen if plen is not None else len(tokens)
        k, v = k[:, 0], v[:, 0]
        for b, key in enumerate(self._keys_for(tokens[:plen])):
            if key in self._store:
                self._store.move_to_end(key)
                continue
            lo, hi = b * self.block_size, (b + 1) * self.block_size
            # copies: a view would keep the whole prompt's rows alive
            k_blk, v_blk = k[:, lo:hi].clone(), v[:, lo:hi].clone()
            nbytes = _nbytes(k_blk) + _nbytes(v_blk)
            while self._bytes + nbytes > self.capacity_bytes and self._store:
                _, (ek, ev) = self._store.popitem(last=False)
                self._bytes -= _nbytes(ek) + _nbytes(ev)
            if self._bytes + nbytes > self.capacity_bytes:
                return  # one block larger than the budget
            self._store[key] = (k_blk, v_blk)
            self._bytes += nbytes

    @property
    def num_blocks(self) -> int:
        return len(self._store)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def clear(self) -> None:
        self._store.clear()
        self._bytes = 0
