"""vptq_tpu_torch's continuous batching and prefix cache against vptq_tpu.

The same requests, prompts from a numpy seed, go through vptq_tpu's
``Scheduler`` and the port's (a tiny model, two layers of width 64, f32
activations over bf16 weights as ``tests/test_scheduler.py`` loads it;
int3 with vptq_tpu's Pallas kernels in interpret mode): each request's
greedy tokens are identical to the JAX scheduler's and to the port's own
``Generator``, in every behaviour ``tests/test_scheduler.py`` pins. The
port's batched step also keeps every cache write inside the cache (a
slot driven to ``max_seq``), and a greedy slot's tokens do not move with
sampled neighbours. ``PrefixCache`` gives the same tokens as no cache, in
the ``Generator`` and the ``Scheduler``, as vptq_tpu's does.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vptq_tpu import native
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.serving.generate import Generator as JGenerator
from vptq_tpu.serving.prefix_cache import PrefixCache as JPrefixCache
from vptq_tpu.serving.scheduler import Scheduler as JScheduler
from vptq_tpu.utils.synth_checkpoint import (
    tiny_model_config,
    write_synthetic_checkpoint,
)
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.serving.generate import Generator
from vptq_tpu_torch.serving.prefix_cache import PrefixCache
from vptq_tpu_torch.serving.scheduler import Scheduler

SMALL_VQ = dict(vector_len=4, num_centroids=64, num_res_centroids=16,
                enable_norm=True, is_indice_packed=True)
PROMPTS = [[1, 2, 3], [9, 8, 7, 6, 5], [42]]
BURST = [[1, 2, 3], [9, 8, 7, 6, 5], [42, 43], [13, 14, 15, 16], [7],
         [200, 201, 202]]


def _load(path, fmt="bf16"):
    return (
        j_load_model(str(path), dtype=jnp.float32, runtime_format=fmt),
        load_model(str(path), dtype=torch.float32, runtime_format=fmt,
                   device="cpu"),
    )


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """tests/test_scheduler.py's model, loaded by both packages."""
    path = tmp_path_factory.mktemp("ckpt")
    write_synthetic_checkpoint(path, tiny_model_config(), vq_kwargs=SMALL_VQ,
                               seed=41)
    return _load(path)


def _fuzz(seed=123, n=12):
    rng = np.random.default_rng(seed)
    return [
        (rng.integers(1, 255, size=int(rng.integers(1, 40))).tolist(),
         int(rng.integers(1, 12)))
        for _ in range(n)
    ]


def _serve(cls, model, dtype, requests, **kw):
    """(outputs in submission order, the scheduler)."""
    sched = cls(model, dtype=dtype, **kw)
    ids = [sched.submit(p, max_new_tokens=n, eos_token_id=eos)
           for p, n, eos in requests]
    got = sched.run()
    return [got[i] for i in ids], sched


def _both(models, requests, **kw):
    """The requests through vptq_tpu's scheduler and the port's: the port's
    outputs (equal to JAX's, or it fails) and its scheduler."""
    jmodel, tmodel = models
    want, _ = _serve(JScheduler, jmodel, jnp.float32, requests, **kw)
    got, sched = _serve(Scheduler, tmodel, torch.float32, requests, **kw)
    assert got == want, (got, want)
    return got, sched


def _singles(tmodel, requests, max_seq=64, buckets=(16,)):
    """Each request alone through the port's Generator, EOS-truncated."""
    gen = Generator(tmodel, max_seq=max_seq, dtype=torch.float32,
                    prompt_buckets=buckets)
    return [gen.generate(p, max_new_tokens=n, eos_token_id=eos)
            for p, n, eos in requests]


def _eos_third(tmodel, cases):
    """The fuzz's requests: every third takes its second greedy token as
    EOS (tests/test_scheduler.py's soak)."""
    refs = _singles(tmodel, [(p, n, None) for p, n in cases])
    return [(p, n, ref[1] if i % 3 == 0 and len(ref) > 1 else None)
            for i, ((p, n), ref) in enumerate(zip(cases, refs))]


# name -> (scheduler arguments, requests (prompt, budget, eos), a stat that
# must be reached)
CASES = {
    "single_sequence": (dict(max_batch=2, chunk=4),
                        [(p, 10, None) for p in PROMPTS], None),
    "long_prompt": (dict(max_batch=2, chunk=4),
                    [(list(range(1, 38)), 6, None)], None),
    "fuzz": (dict(max_batch=3, chunk=3), "fuzz", None),
    "burst": (dict(max_batch=4, chunk=4, admit_parallel=4),
              [(p, 8, None) for p in BURST], "batched_admissions"),
    "prefill_ahead": (dict(max_batch=2, chunk=4, admit_parallel=4),
                      [(p, 8, None) for p in BURST], "prefill_ahead"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scheduler_matches_jax_and_generator(models, case):
    """Each case of tests/test_scheduler.py: the port's scheduler gives
    vptq_tpu's scheduler's tokens and its own Generator's."""
    kw, requests, stat = CASES[case]
    if requests == "fuzz":
        requests = _eos_third(models[1], _fuzz())
    got, sched = _both(models, requests, max_seq=64, prompt_buckets=(16,),
                       **kw)
    assert got == _singles(models[1], requests)
    if stat is not None:
        assert sched.stats[stat] >= 2, sched.stats


def test_scheduler_streaming_and_eos(models):
    ref = _singles(models[1], [([5, 6], 10, None)])[0]
    eos = ref[2]
    streamed = []
    sched = Scheduler(models[1], max_batch=2, max_seq=64, dtype=torch.float32,
                      chunk=4, prompt_buckets=(16,))
    rid = sched.submit([5, 6], max_new_tokens=10, eos_token_id=eos,
                       stream_callback=lambda r, t: streamed.append((r, t)))
    out = sched.run()[rid]
    assert out == ref[: ref.index(eos) + 1]
    assert streamed == [(rid, t) for t in out]
    assert _both(models, [([5, 6], 10, eos)], max_batch=2, max_seq=64,
                 chunk=4, prompt_buckets=(16,))[0] == [out]


def test_max_len_prompt_yields_one_token_inside_the_cache(models):
    """A (max_seq - 1)-token prompt yields its one token, with the slot
    decoding speculatively for ``depth`` chunks behind it: every write of
    those steps stays inside the cache (a scatter past it raises on the
    CPU) and no length passes ``max_seq - 1``."""
    prompt = list(range(1, 64))
    sched = Scheduler(models[1], max_batch=2, max_seq=64, dtype=torch.float32,
                      chunk=4, prompt_buckets=(16,), depth=3)
    seen = []
    run = sched.decode.run

    def spy(steps, seed):
        toks = run(steps, seed)
        seen.append(int(sched.cache.lengths.max()))
        return toks

    sched.decode.run = spy
    rid = sched.submit(prompt, max_new_tokens=8)
    out = sched.run()[rid]
    assert len(out) == 1
    assert len(seen) >= 2 and max(seen) == 63
    assert out == _singles(models[1], [(prompt, 1, None)])[0]
    assert _both(models, [(prompt, 8, None)], max_batch=2, max_seq=64,
                 chunk=4, prompt_buckets=(16,))[0] == [out]


def test_bucket_overflow_does_not_corrupt_the_cache(models):
    """A 35-token prompt chunked 16 + 16 + 16 (padded) into a 40-row cache
    drops the pad rows past the end: the same tokens as a roomy cache,
    in both packages' schedulers and the Generator."""
    prompt = list(range(2, 37))
    want = _singles(models[1], [(prompt, 4, None)])
    got, _ = _both(models, [(prompt, 4, None)], max_batch=2, max_seq=40,
                   chunk=4, prompt_buckets=(16,))
    assert got == want == _singles(models[1], [(prompt, 4, None)],
                                   max_seq=40)


def test_no_head_of_line_blocking(models):
    """Each step runs at most one prefill bucket of a long admission:
    the short request's decode tokens land between the long prompt's
    four chunks."""
    sched = Scheduler(models[1], max_batch=2, max_seq=64, dtype=torch.float32,
                      chunk=2, prompt_buckets=(8,))
    events = []
    one, batch = sched._prefill_one, sched._prefill_fresh_batch

    def logged(inner):
        def call(*a, **kw):
            events.append("prefill")
            return inner(*a, **kw)
        return call

    sched._prefill_one, sched._prefill_fresh_batch = logged(one), logged(batch)
    sched.submit([1, 2, 3], max_new_tokens=20,
                 stream_callback=lambda r, t: events.append("decode"))
    long_id = sched.submit(list(range(1, 33)), max_new_tokens=4)
    sched.run()
    prefill_pos = [i for i, e in enumerate(events) if e == "prefill"]
    assert len(prefill_pos) == 5
    long_chunks = prefill_pos[1:]
    for a, b in zip(long_chunks, long_chunks[1:]):
        assert "decode" in events[a + 1: b], events
    want = _singles(models[1], [(list(range(1, 33)), 4, None)], buckets=(8,))
    assert [sched.finished[long_id].output] == want


def test_pipelined_dispatch_before_consume(models):
    """With depth 2, chunk N + 1 is dispatched before the host consumes
    chunk N (the first consumed entry is the 1-token chunk of the first
    token)."""
    sched = Scheduler(models[1], max_batch=2, max_seq=64, dtype=torch.float32,
                      chunk=4, prompt_buckets=(16,), depth=2)
    events = []
    dispatch, process = sched._dispatch_chunk, sched._process_oldest

    def spy_dispatch():
        dispatch()
        events.append(("d", sched._chunk_idx - 1))

    def spy_process():
        done = sum(1 for e in events if e[0] == "p") - 1
        process()
        events.append(("p", done))

    sched._dispatch_chunk, sched._process_oldest = spy_dispatch, spy_process
    sched.submit([1, 2, 3], max_new_tokens=20)
    sched.run()
    processed = [e for e in events if e[0] == "p"]
    assert len(processed) >= 3
    for _, j in processed[:-1]:  # the tail drain may be synchronous
        assert events.index(("d", j + 1)) < events.index(("p", j)), events


def test_pipeline_depths_identical(models):
    requests = [(p, 9, None) for p in PROMPTS + [[13, 14]]]
    outs = [
        _both(models, requests, max_batch=2, max_seq=64, chunk=4,
              prompt_buckets=(16,), depth=depth)[0]
        for depth in (1, 2, 3)
    ]
    assert outs[0] == outs[1] == outs[2] == _singles(models[1], requests)


def test_greedy_slots_do_not_move_with_sampled_neighbours(models):
    """Greedy requests served beside requests sampled at temperature 0.9
    give the tokens they give alone: a greedy slot takes the argmax of its
    logits whatever its neighbours draw."""
    requests = [(p, 10, None) for p in BURST[:4]]
    alone = _singles(models[1], requests)
    sched = Scheduler(models[1], max_batch=4, max_seq=64, dtype=torch.float32,
                      chunk=4, prompt_buckets=(16,))
    ids = []
    for i, (p, n, _) in enumerate(requests):
        ids.append(sched.submit(p, max_new_tokens=n))
        ids.append(sched.submit(p, max_new_tokens=n, temperature=0.9,
                                seed=i))
    got = sched.run()
    assert [got[i] for i in ids[::2]] == alone
    sampled = [got[i] for i in ids[1::2]]
    assert all(len(s) == 10 for s in sampled) and sampled != alone


@pytest.fixture
def jax_pallas(monkeypatch):
    """vptq_tpu's low-bit path as on a TPU: Pallas in interpret mode (its
    other path does not round x to bf16) and its numpy encoders."""
    monkeypatch.setattr(native, "_lib", lambda: None)
    monkeypatch.setattr(sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL",
                        "pallas")
    monkeypatch.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
    yield
    # jit caches are keyed on shapes, not on the switch: a trace made
    # here would serve a later test at the same shapes on the XLA path
    jax.clear_caches()


def test_scheduler_int3(tmp_path, jax_pallas):
    """The int3 format through both schedulers and the port's Generator."""
    write_synthetic_checkpoint(
        tmp_path, tiny_model_config(hidden_size=128, intermediate_size=256),
        vq_kwargs=SMALL_VQ, seed=43,
    )
    models = _load(tmp_path, "int3")
    requests = [([1, 2, 3], 8, None), ([9, 8, 7], 8, None), ([42], 8, None)]
    got, _ = _both(models, requests, max_batch=2, max_seq=64, chunk=4,
                   prompt_buckets=(16,))
    assert got == _singles(models[1], requests)


# --------------------------------------------------------------- prefix


def test_prefix_cache_block_chaining():
    pc = PrefixCache(block_size=4)
    toks = list(range(10))
    assert pc.match(toks) == 0  # cold
    k = torch.arange(2 * 10 * 2 * 8, dtype=torch.float32).reshape(
        2, 1, 10, 2, 8)
    pc.insert(toks, k, k + 1.0, plen=10)
    assert pc.num_blocks == 2  # two full blocks; the tail is not cached
    assert pc.nbytes == 2 * 2 * (2 * 4 * 2 * 8 * 4)
    assert pc.match(toks) == 8 and pc.hits == 1 and pc.misses == 1
    assert pc.match([99] + toks[1:]) == 0  # chained keys
    got_k, got_v = pc.gather(toks, 8)
    assert torch.equal(got_k, k[:, :, :8])
    assert torch.equal(got_v, k[:, :, :8] + 1.0)
    assert pc.match(toks[:8]) == 4  # never the whole prompt
    pc.clear()
    assert pc.num_blocks == 0 and pc.nbytes == 0


def test_prefix_cache_lru_eviction():
    pc = PrefixCache(block_size=4, capacity_bytes=2048)
    k = torch.zeros((2, 1, 4, 2, 8), dtype=torch.float32)  # 1 KiB a block
    pc.insert([1, 2, 3, 4], k, k)
    pc.insert([5, 6, 7, 8], k, k)
    assert pc.num_blocks == 2
    pc.insert([9, 10, 11, 12], k, k)
    assert pc.num_blocks == 2  # the oldest evicted
    assert pc.match([1, 2, 3, 4, 0]) == 0
    assert pc.match([9, 10, 11, 12, 0]) == 4


def test_generator_prefix_cache_exact(models):
    """Two prompts sharing a 19-token head: the second hits the cache; both
    give the tokens of a Generator without one, and of vptq_tpu's
    Generator with its own prefix cache."""
    jmodel, tmodel = models
    system = list(np.arange(1, 20) % 50)
    prompts = [system + [30, 31], system + [40, 41, 42]]
    kw = dict(max_seq=64, prompt_buckets=(16, 32))
    plain = Generator(tmodel, dtype=torch.float32, **kw)
    want = [plain.generate(p, max_new_tokens=8) for p in prompts]
    pc = PrefixCache(block_size=8)
    gen = Generator(tmodel, dtype=torch.float32, prefix_cache=pc, **kw)
    got = [gen.generate(p, max_new_tokens=8) for p in prompts]
    assert pc.num_blocks > 0 and pc.hits >= 1
    jgen = JGenerator(jmodel, dtype=jnp.float32,
                      prefix_cache=JPrefixCache(block_size=8), **kw)
    assert got == want == [jgen.generate(p, max_new_tokens=8)
                           for p in prompts]


def test_scheduler_prefix_cache_exact(models):
    """Three requests, two sharing a 17-token head, through schedulers
    with and without a prefix cache, in both packages: the same tokens."""
    jmodel, tmodel = models
    system = list(np.arange(1, 18) % 50)
    requests = [(system + [30], 6, None), (system + [40, 41], 6, None),
                ([7, 8, 9], 6, None)]
    kw = dict(max_batch=2, max_seq=64, prompt_buckets=(16, 32))
    want, _ = _serve(Scheduler, tmodel, torch.float32, requests, **kw)
    pc = PrefixCache(block_size=8)
    got, _ = _serve(Scheduler, tmodel, torch.float32, requests,
                    prefix_cache=pc, **kw)
    jgot, _ = _serve(JScheduler, jmodel, jnp.float32, requests,
                     prefix_cache=JPrefixCache(block_size=8), **kw)
    assert got == want == jgot
    assert pc.hits >= 1
    assert got == _singles(tmodel, requests, buckets=(16, 32))


def test_batched_step_advances_only_active_slots(models):
    """Two requests admitted in one batched prefill into three slots, then
    one chunk: each active slot's length on the device is its prompt plus
    the chunk, the empty slot's stays 0."""
    _, tmodel = models
    sched = Scheduler(tmodel, max_batch=3, max_seq=64, dtype=torch.float32,
                      chunk=4, prompt_buckets=(16,), depth=1)
    for p in ([1, 2, 3], list(range(5, 17))):
        sched.submit(p, max_new_tokens=6)
    sched.step()  # both admitted in one batched prefill, one chunk
    assert sched.stats["batched_admissions"] == 2
    assert sched.cache.lengths.tolist() == [3 + 4, 12 + 4, 0]
    assert sched.decode.active.tolist() == [True, True, False]


@pytest.mark.parametrize("n", [1, 3])
def test_batched_admission_prefills_one_row_a_prompt(models, n):
    """``n`` fresh prompts of one bucket go through one batched prefill of
    ``n`` rows, not ``admit_parallel``: no padded row is computed, the
    scratch cache keeps its ``admit_parallel`` rows, and the tokens are
    the Generator's."""
    _, tmodel = models
    sched = Scheduler(tmodel, max_batch=4, max_seq=64, dtype=torch.float32,
                      chunk=4, prompt_buckets=(16,), admit_parallel=4)
    rows = []
    batch = sched._prefill_fresh_batch

    def logged(tokens):
        rows.append(tokens.shape[0])
        return batch(tokens)

    sched._prefill_fresh_batch = logged
    requests = [(p, 6, None) for p in BURST[:n]]
    ids = [sched.submit(p, max_new_tokens=k) for p, k, _ in requests]
    out = sched.run()
    assert rows == [n]
    assert [c.k[0].shape[0] for c in sched._scratch.values()] == [4]
    assert [out[i] for i in ids] == _singles(tmodel, requests)


def test_batched_step_keeps_a_chunk_inside_its_token_buffer(models):
    """The chunk's token buffer holds ``chunk`` rows: a step past it
    raises (its row index lives on the device, where it would leave the
    buffer) until ``begin`` starts the next chunk."""
    sched = Scheduler(models[1], max_batch=2, max_seq=64, dtype=torch.float32,
                      chunk=3, prompt_buckets=(16,))
    decode = sched.decode
    with torch.inference_mode():
        decode.begin(0)
        for _ in range(3):
            decode.step()
        with pytest.raises(ValueError, match="more than 3 steps"):
            decode.eager_step()
        decode.begin(1)
        assert decode.run(3, 2).shape == (3, 2)
