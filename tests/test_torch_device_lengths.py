"""vptq_tpu_torch's cache lengths on the device, per sequence, against
vptq_tpu.

* ``forward`` on a ragged batch (B = 2, unequal lengths; one decode token
  and chunks of 5 and 8, at caches of whole 256-position blocks and not)
  gives the JAX ``forward``'s logits and cache, models carried across with
  ``convert_params`` (f32 activations, so only summation order and
  transcendental rounding differ: 1e-4 of the largest magnitude); a
  chunk whose rows pass ``max_seq`` drops them, as JAX's ``mode="drop"``
  scatter does, and its tokens are JAX's.
* ``_insert_kv`` writes the bytes JAX's ``_insert_kv`` writes, dropped
  rows included.
* The host's plan of block counts follows ``(offset + 256) // 256``.
* One ``Generator`` serves two requests as two fresh JAX ``Generator``s
  do: its one persistent cache is reset per request.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import TINY, VQ, jax_params

from vptq_tpu import native
from vptq_tpu.models import llama as jl
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.serving.generate import Generator as JGenerator
from vptq_tpu.utils.synth_checkpoint import (
    tiny_model_config,
    write_synthetic_checkpoint,
)
from vptq_tpu_torch.convert import convert_params
from vptq_tpu_torch.models import llama as tl
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.serving.generate import (
    DecodeGraphs,
    Generator,
    decode_plan,
)

TOL = 1e-4
KV, HD = TINY["num_key_value_heads"], TINY["head_dim"]

# (max_seq, lengths, chunk): ragged decode and chunks, on a cache of
# whole blocks (256, 512) and not (64); a chunk whose rows pass max_seq
# (60 + 8 > 64, 250 + 8 > 256); one token on either side of a block edge
RAGGED = [
    (64, (3, 40), 1), (64, (3, 40), 5), (256, (3, 40), 1),
    (256, (3, 40), 5), (64, (60, 2), 8), (256, (250, 7), 8),
    (512, (255, 256), 1),
]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt")
    write_synthetic_checkpoint(
        path, tiny_model_config(**TINY, tie_word_embeddings=False),
        vq_kwargs=VQ, seed=4,
    )
    jmodel = j_load_model(str(path), dtype=jnp.float32, runtime_format="bf16")
    with open(path / "config.json") as f:
        hf = json.load(f)
    return jmodel, convert_params(jax_params(jmodel), hf, device="cpu")


def _caches(max_seq, lengths, seed, dtype=np.float32):
    """The same cache in both packages: random K/V in every row (rows
    past a sequence's length must be masked or kept) and ragged
    lengths."""
    rng = np.random.default_rng(seed)
    shape = (len(lengths), max_seq, KV, HD)
    k = [rng.standard_normal(shape).astype(dtype) for _ in range(2)]
    v = [rng.standard_normal(shape).astype(dtype) for _ in range(2)]
    jcache = jl.KVCache(
        k=tuple(jnp.asarray(a) for a in k), v=tuple(jnp.asarray(a) for a in v),
        lengths=jnp.asarray(lengths, jnp.int32),
    )
    tcache = tl.KVCache(
        k=[torch.from_numpy(a.copy()) for a in k],
        v=[torch.from_numpy(a.copy()) for a in v],
        lengths=torch.tensor(lengths, dtype=torch.int64),
        max_len=max(lengths),
    )
    return jcache, tcache


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=TOL, atol=TOL * np.abs(want).max()
    )


@pytest.mark.parametrize("max_seq,lengths,seq", RAGGED)
def test_ragged_forward_matches_vptq_tpu(models, max_seq, lengths, seq):
    jmodel, tmodel = models
    jcache, tcache = _caches(max_seq, lengths, seed=seq)
    tokens = np.random.default_rng(seq).integers(
        0, TINY["vocab_size"], (2, seq))
    want, jcache = jl.forward(
        jmodel, jnp.asarray(tokens, jnp.int32), jcache, dtype=jnp.float32
    )
    with torch.inference_mode():
        got, tcache = tl.forward(
            tmodel, torch.from_numpy(tokens), tcache, dtype=torch.float32
        )
    _close(got, want)
    # the next token of each sequence's last real row is JAX's
    last = [min(seq, max_seq - n) - 1 for n in lengths]
    assert [int(got[b, i].argmax()) for b, i in enumerate(last)] == [
        int(np.asarray(want)[b, i].argmax()) for b, i in enumerate(last)]
    assert tcache.lengths.tolist() == [n + seq for n in lengths]
    assert tcache.max_len == max(lengths) + seq
    np.testing.assert_array_equal(
        np.asarray(jcache.lengths), tcache.lengths.numpy())
    for jbuf, tbuf in zip(jcache.k + jcache.v, tcache.k + tcache.v):
        jbuf, tbuf = np.asarray(jbuf), tbuf.numpy()
        _close(tbuf, jbuf)
        # rows outside [length, length + seq) keep their bytes
        kept = np.ones(jbuf.shape[:2], bool)
        for b, n in enumerate(lengths):
            kept[b, n: n + seq] = False
        np.testing.assert_array_equal(tbuf[kept], jbuf[kept])


@pytest.mark.parametrize("max_seq,lengths,seq", RAGGED)
def test_insert_kv_writes_the_bytes_of_vptq_tpu(max_seq, lengths, seq):
    """f32 rows into a bf16 cache: the same rounding, the same rows
    written and dropped."""
    jcache, tcache = _caches(max_seq, lengths, seed=7, dtype=np.float32)
    jcache = jcache.replace(
        k=tuple(a.astype(jnp.bfloat16) for a in jcache.k),
        v=tuple(a.astype(jnp.bfloat16) for a in jcache.v),
    )
    tcache = dataclasses.replace(
        tcache, k=[a.to(torch.bfloat16) for a in tcache.k],
        v=[a.to(torch.bfloat16) for a in tcache.v],
    )
    rng = np.random.default_rng(seq)
    k = rng.standard_normal((2, seq, KV, HD)).astype(np.float32)
    v = rng.standard_normal((2, seq, KV, HD)).astype(np.float32)
    jcache = jl._insert_kv(1, jnp.asarray(k), jnp.asarray(v), jcache)
    tl._insert_kv(1, torch.from_numpy(k), torch.from_numpy(v), tcache)
    for jbuf, tbuf in ((jcache.k[1], tcache.k[1]), (jcache.v[1], tcache.v[1])):
        np.testing.assert_array_equal(
            tbuf.view(torch.int16).numpy(),
            np.asarray(jbuf).view(np.int16),
        )
    assert tcache.lengths.tolist() == list(lengths)  # the caller advances


def test_insert_kv_refuses_a_chunk_longer_than_the_cache():
    _, tcache = _caches(16, (0,), seed=0)
    rows = torch.zeros((1, 17, KV, HD))
    with pytest.raises(ValueError, match="max_seq"):
        tl._insert_kv(0, rows, rows, tcache)


def test_block_plan_follows_each_offset():
    """The block counts the host plans at lengths 254–258: (offset + 256)
    // 256, the JAX package's while_loop trip count; a cache that is no
    whole number of blocks attends its live prefix instead."""
    offsets = range(254, 259)
    assert decode_plan(254, 5, 512) == [(n + 256) // 256 for n in offsets]
    assert decode_plan(254, 5, 512) == [1, 1, 2, 2, 2]
    assert decode_plan(510, 4, 2048) == [2, 2, 3, 3]
    assert [tl.attended(n, 1, 512) for n in offsets] == [256, 256, 512, 512,
                                                        512]
    assert [tl.attended(n, 1, 300) for n in offsets] == [255, 256, 257, 258,
                                                        259]
    assert tl.attended(40, 5, 256) == 45 and tl.attended(60, 8, 64) == 64


@pytest.fixture
def jax_pallas_int8(monkeypatch):
    """vptq_tpu's int8 path as on a TPU: the Pallas kernel (interpret
    mode) and the numpy encoder."""
    monkeypatch.setattr(native, "_lib", lambda: None)
    monkeypatch.setattr(
        sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL", "pallas"
    )
    monkeypatch.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
    yield
    # jit caches are keyed on shapes, not on the switch: a trace made
    # here would serve a later test at the same shapes on the XLA path
    jax.clear_caches()


@pytest.mark.parametrize("max_seq", [44, 256])
def test_one_generator_serves_two_requests_as_two_fresh_ones(
        tmp_path, jax_pallas_int8, max_seq):
    """A long request, then a shorter one whose cache rows beyond its
    length still hold the first's K/V (at max_seq 44 the second prompt's
    padded chunk also passes max_seq): the tokens of two fresh JAX
    Generators."""
    write_synthetic_checkpoint(
        tmp_path, tiny_model_config(**TINY, tie_word_embeddings=False),
        vq_kwargs=VQ, seed=3,
    )
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, TINY["vocab_size"], n) for n in (30, 36)]
    buckets = (16, 32)
    jmodel = j_load_model(str(tmp_path), dtype=jnp.float32,
                          runtime_format="int8")
    want = [
        JGenerator(jmodel, max_seq=max_seq, dtype=jnp.float32,
                   prompt_buckets=buckets).generate(
            p, max_new_tokens=12, chunk_size=5)
        for p in prompts
    ]
    tmodel = load_model(str(tmp_path), dtype=torch.float32,
                        runtime_format="int8", device="cpu")
    gen = Generator(tmodel, max_seq=max_seq, dtype=torch.float32,
                    prompt_buckets=buckets)
    cache = gen.cache
    got = [gen.generate(p, max_new_tokens=12, chunk_size=5) for p in prompts]
    assert gen.cache is cache and gen.graphs is None  # the CPU: no graphs
    assert len(want[1]) == min(12, max_seq - 36)
    assert got == want


def test_decode_graphs_need_a_cuda_cache():
    cache = tl.init_cache(
        tl.ModelConfig.from_hf_dict(dict(TINY)), 1, 256, torch.float32, "cpu")
    assert cache.lengths.dtype == torch.int64 and cache.max_len == 0
    with pytest.raises(ValueError, match="CUDA"):
        DecodeGraphs(None, cache, torch.float32)
    cache.reset(7)
    assert cache.lengths.tolist() == [7] and cache.max_len == 7
