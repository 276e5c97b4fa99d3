"""vptq_tpu_torch's pipeline parallelism against vptq_tpu's.

``PipelineRunner`` runs in this process over CPU devices; the JAX side on
``tests/conftest.py``'s 8 CPU devices, its Pallas kernels in interpret
mode and its numpy encoders, as the other port tests run it.
``TPPipelineRunner`` runs as 4 ranks of a gloo group on the CPU
(``torch_port.pp_rank_cases``, one spawn for every case of this file).

* ``pp_stage_of`` equal to JAX's for every L ≤ 12, n ≤ L.
* ``PipelineRunner.forward`` (a prefill and a decode step) within 1e-4 of
  max |logit| of JAX's ``PipelineRunner`` at 2 and 4 stages, in f32, in
  int8, int4, int2 and bf16 (tied), the same argmax; and equal to the
  port's own ``forward``.
* ``forward_pipelined`` against JAX's, the stage caches untouched by it
  (JAX's slices are copies) and ``forward`` after it what it is on a
  fresh runner.
* ``TPPipelineRunner`` at 2 stages × TP 2 and the single-stage tied case
  (TP 4) against JAX's, logits on the last stage's ranks only; its 1F
  schedule; JAX's refusal messages.
* The smoke's pipeline phase rehearsed on the CPU.
"""

import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import TINY, VQ, pp_rank_cases, spawn_ranks

import chip_smoke
from vptq_tpu import native
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.parallel import pipeline as jpp
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu_torch.models.llama import forward, init_cache
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.parallel import pipeline as pp

LLAMA = dict(TINY, num_hidden_layers=4, tie_word_embeddings=False)
TIED = dict(TINY, num_hidden_layers=4)  # TINY ties its embeddings
# 4 KV heads, so that one stage spans 4 ranks
TIED4 = dict(TIED, num_key_value_heads=4)
TOKENS = [[1, 7, 42, 9, 100, 3]]
# (format, config) of the PipelineRunner cases
FORMATS = [("int8", LLAMA), ("int4", LLAMA), ("int2", LLAMA),
           ("bf16", TIED)]


@pytest.fixture(scope="module")
def jax_pallas():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_lib", lambda: None)
        mp.setattr(sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL",
                   "pallas")
        mp.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
        yield
    # jit caches are keyed on shapes, not on the switch
    jax.clear_caches()


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """One JAX-written checkpoint per configuration."""
    root = tmp_path_factory.mktemp("pp")
    out = {}
    for name, cfg in (("llama", LLAMA), ("tied", TIED), ("tied4", TIED4),
                      ("two", dict(LLAMA, num_hidden_layers=2)),
                      ("tied2", dict(TIED, num_hidden_layers=2))):
        path = root / name
        jsc.write_synthetic_checkpoint(str(path), jsc.tiny_model_config(**cfg),
                                       vq_kwargs=VQ, seed=17)
        out[name] = str(path)
    return out


def _ckpt_of(cfg, ckpts):
    return ckpts["tied" if cfg is TIED else "llama"]


def _assert_close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, err / scale


def test_stage_assignment_is_jax_for_every_split():
    for L in range(1, 13):
        for n in range(1, L + 1):
            got = [pp.pp_stage_of(i, L, n) for i in range(L)]
            assert got == [jpp.pp_stage_of(i, L, n) for i in range(L)]
            # contiguous, every stage at least one block
            assert got == sorted(got) and set(got) == set(range(n))
    assert [pp.pp_stage_of(i, 10, 4) for i in range(10)] == [
        0, 0, 0, 1, 1, 1, 2, 2, 3, 3]


@pytest.fixture(scope="module")
def jax_runs(ckpts, jax_pallas):
    """{(format, stages): JAX PipelineRunner's prefill and decode logits
    and the decode token}, f32."""
    out = {}
    for fmt, cfg in FORMATS:
        jmodel = j_load_model(_ckpt_of(cfg, ckpts), runtime_format=fmt,
                              dtype=jnp.float32)
        toks = jnp.asarray(TOKENS, jnp.int32)
        for n in (2, 4):
            runner = jpp.PipelineRunner(jmodel, jax.devices()[:n], max_seq=16,
                                        dtype=jnp.float32)
            first = np.asarray(runner.forward(toks, fresh=True))
            nxt = np.argmax(first[:, -1:], axis=-1).astype(np.int64)
            step = np.asarray(runner.forward(jnp.asarray(nxt, jnp.int32)))
            out[fmt, n] = (first, nxt, step)
    return out


@pytest.mark.parametrize("stages", [2, 4])
@pytest.mark.parametrize("fmt,cfg", FORMATS, ids=[f for f, _ in FORMATS])
def test_pipeline_runner_matches_jax(ckpts, jax_runs, fmt, cfg, stages):
    first, nxt, step = jax_runs[fmt, stages]
    model = load_model(_ckpt_of(cfg, ckpts), dtype=torch.float32,
                       runtime_format=fmt, device="cpu")
    runner = pp.PipelineRunner(model, ["cpu"] * stages, max_seq=16,
                               dtype=torch.float32)
    assert [len(s.blocks) for s in runner.stages] == [
        sum(jpp.pp_stage_of(i, 4, stages) == s for i in range(4))
        for s in range(stages)]
    with torch.inference_mode():
        got1 = runner.forward(torch.tensor(TOKENS), fresh=True)
        got2 = runner.forward(torch.from_numpy(nxt))
        # the port's own forward on the same inputs
        cache = init_cache(model.cfg, 1, 16, torch.float32, "cpu")
        one1, _ = forward(model, torch.tensor(TOKENS), cache,
                          dtype=torch.float32, fresh_prefill=True)
        one2, _ = forward(model, torch.from_numpy(nxt), cache,
                          dtype=torch.float32)
    for got, want in ((got1, first), (got2, step)):
        _assert_close(got.numpy(), want)
        assert (got.numpy().argmax(-1) == want.argmax(-1)).all()
    assert torch.equal(got1, one1) and torch.equal(got2, one2)
    # each stage's cache holds its layers only, advanced by both calls
    for s, cache in enumerate(runner.caches):
        assert len(cache.k) == len(runner.stages[s].blocks)
        assert cache.max_len == 7 and cache.lengths.tolist() == [7]


def test_tied_embedding_goes_to_the_last_stage(ckpts):
    model = load_model(ckpts["tied"], dtype=torch.float32,
                       runtime_format="int8", device="cpu")
    runner = pp.PipelineRunner(model, ["cpu"] * 2, max_seq=16)
    first, last = runner.stages
    assert first.embed_tokens is model.embed_tokens
    assert last.lm_head is None and last.embed_tokens is not None
    assert first.norm is None and last.norm is not None
    # the stages of one device share the model's weights
    assert first.blocks[0] is model.blocks[0]


def test_pipelined_microbatches_match_jax(ckpts, jax_pallas):
    """Two 1-row microbatches through 4 stages: JAX's logits, a decode step
    on each microbatch's own caches, the stage caches untouched, and a
    ``forward`` after them what it is on a fresh runner."""
    jmodel = j_load_model(ckpts["llama"], runtime_format="int8",
                          dtype=jnp.float32)
    toks = np.asarray([[1, 7, 42], [9, 3, 5]])
    jr = jpp.PipelineRunner(jmodel, jax.devices()[:4], max_seq=16, batch=2,
                            dtype=jnp.float32)
    jt = jnp.asarray(toks, jnp.int32)
    want = [np.asarray(o) for o in jr.forward_pipelined([jt[0:1], jt[1:2]],
                                                        fresh=True)]
    nxt = np.concatenate([w[:, -1:].argmax(-1) for w in want])
    jn = jnp.asarray(nxt, jnp.int32)
    want2 = [np.asarray(o) for o in jr.forward_pipelined([jn[0:1], jn[1:2]])]

    model = load_model(ckpts["llama"], dtype=torch.float32,
                       runtime_format="int8", device="cpu")
    runner = pp.PipelineRunner(model, ["cpu"] * 4, max_seq=16, batch=2,
                               dtype=torch.float32)
    t, n = torch.from_numpy(toks), torch.from_numpy(nxt)
    with torch.inference_mode():
        got = runner.forward_pipelined([t[0:1], t[1:2]], fresh=True)
        got2 = runner.forward_pipelined([n[0:1], n[1:2]])
    for g, w in zip(got + got2, want + want2):
        _assert_close(g.numpy(), w)
    for stage in runner.mb_caches.values():
        assert [c.lengths.tolist() for c in stage] == [[4], [4]]
    # JAX's row split is a copy: the stage caches are as they were
    for cache in runner.caches:
        assert cache.lengths.tolist() == [0, 0] and cache.max_len == 0
        assert all(not k.any() for k in cache.k)
    with torch.inference_mode():
        after = runner.forward(t, fresh=True)
        fresh = pp.PipelineRunner(model, ["cpu"] * 4, max_seq=16, batch=2,
                                  dtype=torch.float32).forward(t, fresh=True)
    assert torch.equal(after, fresh)
    with pytest.raises(ValueError, match="microbatch rows 3 exceed cache "
                       "batch 2"):
        pp.PipelineRunner(model, ["cpu"] * 2, batch=2).forward_pipelined(
            [t[0:1], t])


def test_more_devices_than_layers_is_jax_message(ckpts):
    model = load_model(ckpts["two"], runtime_format="int8", device="cpu")
    jmodel = j_load_model(ckpts["two"], runtime_format="int8")
    with pytest.raises(ValueError) as got:
        pp.PipelineRunner(model, ["cpu"] * 3)
    with pytest.raises(ValueError) as want:
        jpp.PipelineRunner(jmodel, jax.devices()[:3])
    assert str(got.value) == str(want.value)


# ------------------------------------------------------ TPPipelineRunner

# (name, checkpoint, format, tp, microbatches)
TP_CASES = [
    ("2x2-int8", "llama", "int8", 2, [[[2 + i, 9, 4]] for i in range(3)]),
    ("2x2-int4", "llama", "int4", 2, None),
    ("1x4-tied", "tied4", "int8", 4, None),
]
# (checkpoint, tp) each construction refuses, at world 4
TP_REFUSALS = {
    "split": ("llama", 3),  # 4 devices into groups of 3
    "depth": ("two", 1),  # 4 stages of 2 layers
    "heads": ("llama", 4),  # 2 KV heads over 4 ranks
    "tied": ("tied2", 2),  # a tied head on the second of 2 stages
}


@pytest.fixture(scope="module")
def tp_runs(ckpts, tmp_path_factory):
    root = tmp_path_factory.mktemp("tpp")
    spec = dict(
        cases=[dict(name=name, ckpt=ckpts[ck], fmt=fmt, tp=tp,
                    tokens=TOKENS, next=[[11]], chunks=chunks)
               for name, ck, fmt, tp, chunks in TP_CASES],
        refusals={k: (ckpts[c], tp) for k, (c, tp) in TP_REFUSALS.items()},
    )
    torch.save(spec, root / "spec.pt")
    spawn_ranks(pp_rank_cases, 4, root, str(root / "spec.pt"), str(root))
    return [torch.load(root / f"pp{r}.pt") for r in range(4)]


@pytest.mark.parametrize("case", TP_CASES, ids=[c[0] for c in TP_CASES])
def test_tp_pipeline_matches_jax(ckpts, tp_runs, jax_pallas, case):
    name, ck, fmt, tp, chunks = case
    jmodel = j_load_model(ckpts[ck], runtime_format=fmt, dtype=jnp.float32)
    runner = jpp.TPPipelineRunner(jmodel, jax.devices()[:4], tp=tp,
                                  max_seq=16, dtype=jnp.float32)
    want1 = np.asarray(runner.forward(jnp.asarray(TOKENS, jnp.int32),
                                      fresh=True))
    want2 = np.asarray(runner.forward(jnp.asarray([[11]], jnp.int32)))
    n = 4 // tp
    for rank, res in enumerate(tp_runs):
        r = res[name]
        assert (r["stage"], r["n_stages"]) == (rank // tp, n)
        if r["stage"] < n - 1:
            # the logits live on the last stage's ranks only
            assert r["logits"] is None and r["step"] is None
            continue
        _assert_close(r["logits"].numpy(), want1)
        _assert_close(r["step"].numpy(), want2)
    if chunks:
        jp = jpp.TPPipelineRunner(jmodel, jax.devices()[:4], tp=tp,
                                  max_seq=16, batch=len(chunks),
                                  dtype=jnp.float32)
        want = jp.forward_pipelined(
            [jnp.asarray(c, jnp.int32) for c in chunks], fresh=True)
        for rank, res in enumerate(tp_runs):
            r = res[name]
            # the 1F schedule: every rank one stage step a microbatch
            assert r["piped_calls"] == [rank // tp] * len(chunks)
            for got, w in zip(r["piped"], want):
                if r["stage"] == n - 1:
                    _assert_close(got.numpy(), np.asarray(w))
                else:
                    assert got is None


def test_tp_pipeline_refusals_are_jax_messages(ckpts, tp_runs):
    for name, (ck, tp) in TP_REFUSALS.items():
        jmodel = j_load_model(ckpts[ck], runtime_format="int8")
        try:
            jpp.TPPipelineRunner(jmodel, jax.devices()[:4], tp=tp)
            want = None
        except (ValueError, NotImplementedError) as e:
            want = (type(e).__name__, str(e))
        assert want is not None, name
        for res in tp_runs:
            assert res["refusals"][name] == want, name


# ------------------------------------------------------------- the smoke


def test_chip_smoke_pp_on_cpu():
    """The smoke's pipeline phase at a tiny size with the plain versions:
    2 and 4 stages give the Generator's tokens, forward_pipelined equals
    each row alone, the stage caches stay untouched."""
    cfg = dict(LLAMA)
    path, _ = chip_smoke.write_checkpoint(cfg, VQ)
    try:
        e2e = chip_smoke.phase_e2e("cpu", path, "int4", TINY["vocab_size"],
                                   prompt_lens=(5, 40), new_tokens=6,
                                   max_seq=256, pp=True)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    got = e2e["pp"]
    assert sorted(got["runs"]) == [2, 4]
    for n, run in got["runs"].items():
        assert run["tokens_equal_one_device"] and run["logits_gap"] == 0.0
        assert run["blocks"] == [4 // n] * n
    assert got["pipelined"]["bit_equal_to_each_row"]
    assert got["pipelined"]["stage_caches_untouched"]
    assert set(got["launches"].values()) == {0}  # the CPU launches nothing
