"""vptq_tpu_torch's context parallelism against vptq_tpu's.

The port runs as ranks of a gloo group on the CPU
(``torch_port.cp_rank_cases``, one spawn per world size for every case of
this file); the JAX side on ``tests/conftest.py``'s 8 CPU devices through
its own ``ring_attention`` in ``shard_map``, ``prefill_cp``,
``Generator(mesh=)`` and ``Scheduler(mesh=)``, its Pallas kernels in
interpret mode and its numpy encoders, as the other port tests run it.

* ``ring_attention`` at world 2 and 4 against JAX's and against a dense
  causal softmax, with GQA, to 1e-5.
* ``prefill_cp`` at data 2 × model 1 and 2 × 2: each rank's chunk of the
  logits within 1e-4 of max |logit| of JAX's, the cache's K / V within
  1e-5 of JAX's on every data rank, the lengths, the last row on every
  rank, a decode step from the cache.
* ``Generator(mesh=)`` and ``Scheduler(mesh=)`` at data 2 × model 2 give
  JAX's greedy tokens (``tests/test_ring.py``'s cases).
* JAX's refusals: a length that does not divide the data axis, a sliding
  window, MLA, a prefill that is not fresh.
* The smoke's 4-rank job rehearsed on the CPU.
"""

import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P
from torch_port import TINY, VQ, cp_rank_cases, spawn_ranks

import chip_smoke
from vptq_tpu import native
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.models.llama import forward as j_forward
from vptq_tpu.models.llama import init_cache as j_init_cache
from vptq_tpu.parallel import ring as jring
from vptq_tpu.parallel import tp as jtp
from vptq_tpu.parallel.sharding import make_mesh as j_make_mesh
from vptq_tpu.serving.generate import Generator as JGenerator
from vptq_tpu.serving.scheduler import Scheduler as JScheduler
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu_torch.models.llama import forward, init_cache
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.parallel import ring, tp
from vptq_tpu_torch.parallel.mesh import Mesh
from vptq_tpu_torch.utils import synth_checkpoint as tsc

LLAMA = dict(TINY, tie_word_embeddings=False)
TOKENS = [[1, 7, 42, 9, 3, 5, 2, 8]]
# tests/test_ring.py's serving cases
GENERATE = [1, 7, 42, 9, 3, 5, 2, 8, 11, 4]
SCHEDULE = [[1, 2, 3, 4], [9, 8, 7, 6, 5, 4, 3]]
# (name, q heads, kv heads, batch, sequence, head size)
RING = [("mha", 4, 4, 2, 32, 16), ("gqa", 8, 2, 1, 16, 8)]
# (name, data axis, format, the serving cases) at each world size
CASES = {
    2: [("cp2x1-int8", 2, "int8", False)],
    4: [("cp2x2-int8", 2, "int8", True), ("cp2x2-int4", 2, "int4", False)],
}


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
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("cp") / "llama"
    jsc.write_synthetic_checkpoint(str(path), jsc.tiny_model_config(**LLAMA),
                                   vq_kwargs=VQ, seed=17)
    return str(path)


def _qkv(h, kv, b, s, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0, 1, (b, s, n, d)).astype(np.float32)
                 for n in (h, kv, kv))


RING_INPUTS = {name: _qkv(h, kv, b, s, d, seed)
               for seed, (name, h, kv, b, s, d) in enumerate(RING)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, ckpt):
    """{world: each rank's results}."""
    root = tmp_path_factory.mktemp("cpr")
    out = {}
    for world, cases in CASES.items():
        spec = dict(
            ring={k: tuple(torch.from_numpy(a) for a in v)
                  for k, v in RING_INPUTS.items()},
            cases=[dict(name=name, data=data, fmt=fmt, ckpt=ckpt,
                        tokens=TOKENS, next=[[11]],
                        generate=GENERATE if serve else None,
                        schedule=SCHEDULE if serve else None)
                   for name, data, fmt, serve in cases],
        )
        torch.save(spec, root / f"spec{world}.pt")
        spawn_ranks(cp_rank_cases, world, root, str(root / f"spec{world}.pt"),
                    str(root))
        out[world] = [torch.load(root / f"cp{r}.pt") for r in range(world)]
    return out


def _jax_ring(q, k, v, n):
    mesh = JMesh(np.asarray(jax.devices()[:n]), ("x",))
    spec = P(None, "x", None, None)
    return np.asarray(jax.jit(jax.shard_map(
        lambda q, k, v: jring.ring_attention(q, k, v, "x", n,
                                             q.shape[-1] ** -0.5),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False))(q, k, v))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", [r[0] for r in RING])
def test_ring_attention_matches_jax_and_dense(runs, world, name):
    q, k, v = RING_INPUTS[name]
    want = _jax_ring(q, k, v, world)
    dense = np.asarray(jring.chunk_attention(q, k, v, True,
                                             q.shape[-1] ** -0.5)[0])
    # the port's own dense block equals JAX's
    np.testing.assert_allclose(
        ring.chunk_attention(*map(torch.from_numpy, (q, k, v)), True,
                             q.shape[-1] ** -0.5)[0].numpy(),
        dense, rtol=1e-5, atol=1e-5)
    got = np.concatenate([r["ring"][name].numpy() for r in runs[world]],
                         axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5)


def _jax_cp(ckpt, world, data, fmt):
    """JAX's prefill_cp and a decode step after it, on ``data`` × (world /
    data) devices; the cache's per-device K / V shards in mesh order."""
    mesh = j_make_mesh(data=data, model=world // data,
                       devices=np.asarray(jax.devices()[:world]))
    model = j_load_model(ckpt, runtime_format=fmt, dtype=jnp.float32,
                         mesh=mesh, parallel="tp")
    specs = jtp.tp_specs(model)
    cache = jtp.shard_cache_tp(j_init_cache(model.cfg, 1, 32, jnp.float32),
                               mesh)
    with mesh:
        logits, cache = jtp.prefill_cp(model, jnp.asarray(TOKENS, jnp.int32),
                                       cache, specs, mesh, dtype=jnp.float32)
        kv = {part: [[np.asarray(sh.data) for sh in sorted(
            buf.addressable_shards,
            key=lambda sh: list(mesh.devices.flat).index(sh.device))]
            for buf in getattr(cache, part)] for part in ("k", "v")}
        lengths = np.asarray(cache.lengths)
        step, _ = jtp.forward_tp(model, jnp.asarray([[11]], jnp.int32), cache,
                                 specs, mesh, dtype=jnp.float32)
    return dict(logits=np.asarray(logits), kv=kv, lengths=lengths,
                step=np.asarray(step), mesh=mesh, model=model)


def _assert_close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err / np.abs(want).max()


ALL = [(w, c[0]) for w, cs in CASES.items() for c in cs]


@pytest.mark.parametrize("world,name", ALL)
def test_prefill_cp_matches_jax(ckpt, runs, jax_pallas, world, name):
    data, fmt = next((c[1], c[2]) for c in CASES[world] if c[0] == name)
    j = _jax_cp(ckpt, world, data, fmt)
    n = len(TOKENS[0])
    c = n // data
    model_axis = world // data
    for rank, res in enumerate(runs[world]):
        r = res[name]
        d = rank // model_axis
        # this rank's chunk, in sequence order
        _assert_close(r["logits"].numpy(), j["logits"][:, d * c:(d + 1) * c],
                      1e-4)
        # the row of the last position on every rank, from its owner
        _assert_close(r["row"].numpy(), j["logits"][:, n - 1], 1e-4)
        for part in ("k", "v"):
            for layer, shards in enumerate(j["kv"][part]):
                want = shards[rank][:, :n]
                np.testing.assert_allclose(r[part][layer].numpy(), want,
                                           rtol=1e-5, atol=1e-5)
        # the whole prompt cached on every data rank
        assert r["lengths"].tolist() == j["lengths"].tolist() == [n]
        assert r["max_len"] == n
        _assert_close(r["step"].numpy(), j["step"], 1e-4)


def test_generator_and_scheduler_match_jax(ckpt, runs, jax_pallas):
    """tests/test_ring.py's cases at data 2 × model 2: the Generator's
    context-parallel prefill gives JAX's greedy tokens, and the
    Scheduler's admissions (context-parallel, its two slots one on each
    data rank) give JAX's Scheduler's and the Generator's."""
    mesh = j_make_mesh(data=2, model=2, devices=np.asarray(jax.devices()[:4]))
    model = j_load_model(ckpt, runtime_format="int8", dtype=jnp.float32,
                         mesh=mesh, parallel="tp")
    gen = JGenerator(model, max_seq=64, dtype=jnp.float32,
                     prompt_buckets=(16,), mesh=mesh)
    greedy = gen.generate(GENERATE, max_new_tokens=10)
    singles = [gen.generate(p, max_new_tokens=6) for p in SCHEDULE]
    sched = JScheduler(model, max_batch=2, max_seq=64, dtype=jnp.float32,
                       chunk=4, prompt_buckets=(16,), mesh=mesh)
    ids = [sched.submit(p, max_new_tokens=6) for p in SCHEDULE]
    outs = sched.run()
    served = [outs[i] for i in ids]
    assert served == singles
    for res in runs[4]:
        r = res["cp2x2-int8"]
        assert r["greedy"] == greedy
        assert r["singles"] == singles
        assert r["served"] == served
        assert r["slots_here"] == 1  # the slots ride the data axis


def test_refusals_are_jax_messages(tmp_path, ckpt):
    """Without a process group: each refusal comes before any collective."""
    mesh = Mesh(data=2, model=1)
    jmesh = j_make_mesh(data=2, model=1, devices=np.asarray(jax.devices()[:2]))
    toks = [[1, 2, 3, 4, 5, 6, 7]]

    def pair(port_fn, jax_fn):
        with pytest.raises((ValueError, NotImplementedError)) as got:
            port_fn()
        with pytest.raises((ValueError, NotImplementedError)) as want:
            jax_fn()
        assert (type(got.value), str(got.value)) == (
            type(want.value), str(want.value))
        return str(got.value)

    def both(cfg, name):
        # the port's writer: JAX's leaves a window out of config.json
        path = tmp_path / name
        tsc.write_synthetic_checkpoint(str(path), tsc.tiny_model_config(**cfg),
                                       vq_kwargs=VQ, seed=3)
        model = load_model(str(path), dtype=torch.float32,
                           runtime_format="int8", device="cpu")
        jmodel = j_load_model(str(path), runtime_format="int8",
                              dtype=jnp.float32)
        placed, specs = jtp.tp_place_model(jmodel, jmesh)
        return model, jmodel, placed, specs

    def port_cp(model, tokens):
        cache = init_cache(model.cfg, 1, 32, torch.float32, "cpu")
        return tp.prefill_cp(model, torch.tensor(tokens), cache, mesh,
                             torch.float32)

    def jax_cp(jmodel, placed, specs, tokens):
        cache = jtp.shard_cache_tp(
            j_init_cache(jmodel.cfg, 1, 32, jnp.float32), jmesh)
        with jmesh:
            return jtp.prefill_cp(placed, jnp.asarray(tokens, jnp.int32),
                                  cache, specs, jmesh, dtype=jnp.float32)

    model = load_model(ckpt, dtype=torch.float32, runtime_format="int8",
                       device="cpu")
    jmodel = j_load_model(ckpt, runtime_format="int8", dtype=jnp.float32)
    placed, specs = jtp.tp_place_model(jmodel, jmesh)
    assert "must divide cp=2" in pair(
        lambda: port_cp(model, toks), lambda: jax_cp(jmodel, placed, specs,
                                                     toks))
    # not a fresh prefill
    assert pair(
        lambda: forward(model, torch.tensor(TOKENS),
                        init_cache(model.cfg, 1, 32, torch.float32, "cpu"),
                        dtype=torch.float32, cp=mesh.cp),
        lambda: j_forward(jmodel, jnp.asarray(TOKENS, jnp.int32),
                          j_init_cache(jmodel.cfg, 1, 32, jnp.float32),
                          dtype=jnp.float32, cp=("data", 2)),
    ) == "context parallelism needs fresh_prefill"
    window = dict(LLAMA, model_type="mistral", sliding_window=4)
    model, jmodel, placed, specs = both(window, "mistral")
    assert model.cfg.sliding_window == jmodel.cfg.sliding_window == 4
    assert "sliding-window" in pair(
        lambda: port_cp(model, TOKENS),
        lambda: jax_cp(jmodel, placed, specs, TOKENS))
    mla = dict(
        model_type="deepseek_v3", vocab_size=256, hidden_size=64,
        intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=4, head_dim=16, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        moe_intermediate_size=32, n_routed_experts=4, num_experts_per_tok=2,
        n_shared_experts=1, first_k_dense_replace=2, tie_word_embeddings=True,
    )
    model, jmodel, placed, specs = both(mla, "deepseek")
    assert pair(lambda: port_cp(model, TOKENS),
                lambda: jax_cp(jmodel, placed, specs, TOKENS)
                ) == "MLA under context parallelism"


# ------------------------------------------------------------- the smoke


def test_chip_smoke_cp_on_cpu(monkeypatch):
    """The smoke's 4-rank job at a tiny size with the plain versions:
    prefill_cp, Generator(mesh=), Scheduler(mesh=) and TPPipelineRunner on
    four gloo ranks, every kernel call held, the ranks agreeing, the
    transfers of each part counted (the smoke's checks against one device
    need Llama-3.1-8B's widths: here printed)."""
    cfg = dict(LLAMA, num_hidden_layers=4)
    path, _ = chip_smoke.write_checkpoint(cfg, VQ)
    try:
        ref = chip_smoke.cp_reference("cpu", path, "int4", 256,
                                      Path(path, "ref.pt"), prompt=32,
                                      greedy_prompt=20, greedy=4)
        job = dict(label="tiny", fmt="int4", path=path, vocab=256,
                   reference=ref, prompt=32, greedy_prompt=20, greedy=4,
                   serve=dict(max_batch=4, max_seq=256, chunk=4, depth=2,
                              admit_parallel=2, prompt_buckets=(16, 32)),
                   serve_lens=(5, 20, 40), cp=True, device="cpu",
                   strict=False)
        # one thread a rank, as torch_port sets it in this process
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        results = chip_smoke.run_ranks([job], world=4)
        launches = chip_smoke.report_tp(results, "cpu", "cp",
                                        chip_smoke.CP_LABEL)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    assert set(launches.values()) == {0}  # the CPU launches nothing
    for rank, (r,) in enumerate(results):
        assert r["rank"] == rank and r["backend"] == "gloo"
        assert r["decode_mode"] == "eager"
        assert r["cp"]["cache_length"] == 32
        assert r["serving"]["requests"] == 3 and r["serving"]["tokens"] == 12
        assert r["serving"]["slots_here"] == 2
        assert r["tp_pipeline"]["stage"] == rank // 2
        assert r["greedy_tokens"] == results[0][0]["greedy_tokens"]
        # one ring hop a layer (k and v) and a chunk of the row broadcast
        assert r["parts"]["prefill_cp"]["transfers"]["isend"] == 2 * 4
        # a stage boundary: the first stage sends, the second receives
        sent = r["parts"]["tp_pipeline"]["transfers"]
        assert sent.get("isend" if rank < 2 else "irecv") == 4
        assert sum(h["calls"] for h in r["held"].values()) > 0
