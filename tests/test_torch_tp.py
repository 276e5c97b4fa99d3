"""vptq_tpu_torch's tensor and expert parallelism against vptq_tpu's.

The port runs as ranks of a gloo group on the CPU (``torch_port
.tp_rank_cases``, one spawn per world size for every case of this file);
the JAX side runs on ``tests/conftest.py``'s 8 CPU devices through its own
``load_model(mesh=, parallel="tp")``, ``tp_place_model``, ``forward_tp``,
``Generator(mesh=)`` and ``Scheduler(mesh=)``, its Pallas kernels in
interpret mode and its numpy encoders, as the other port tests run it.

* Placement: each rank's shard, from the sharded load and from placing a
  one-device load, byte-equal to device ``rank``'s arrays of JAX's placed
  model (carried across by ``convert.convert_shard``); the bf16 load equal
  to placing a one-device load.
* Logits: ``forward_tp`` over a prefill and a decode step within 1e-4 of
  max |logit| of JAX's, in f32, at world 2 and 4, in int8, int4, int3,
  int2 and bf16; Qwen2's qkv bias, Phi-3's fused layout, Mixtral under
  expert parallelism on both sides of ``_MOE_FAST_MAX_TOKENS``, DeepSeek
  (MLA, grouped MoE, shared experts), and DP × TP 2 × 2. The few rows
  that pass a bf16 rounding edge inside a kernel are named case by case
  (``ROUNDING_EDGE``), each with its bound; every decode step is held to
  1e-4.
* ``moe_forward_ep`` on ``shard_stacked_experts``, ``shard_cache_tp``
  and ``batch_axis``.
* Memory: the ranks' placed bytes against ``estimate_model_bytes(
  tp_shards=n)`` (JAX's own rule, within 2%).
* Serving: ``Generator(mesh=)`` and ``Scheduler(mesh=)`` give JAX's greedy
  tokens; sampling is the same on every rank and in every run.
* Refusals: JAX's messages for divisibility, a row-parallel bias, the
  codebook format and a row-parallel mixed layer to re-encode (the mixed
  formats under a mesh are ``tests/test_torch_tp_calibrate.py``'s, a data
  axis in serving ``tests/test_torch_ring.py``'s).
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import TINY, VQ, jax_params, spawn_ranks, tp_rank_cases

from vptq_tpu import native
from vptq_tpu.config import QuantizationConfig as JQuantizationConfig
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.models.llama import init_cache as j_init_cache
from vptq_tpu.parallel import tp as jtp
from vptq_tpu.parallel.sharding import make_mesh as j_make_mesh
from vptq_tpu.serving.generate import Generator as JGenerator
from vptq_tpu.serving.scheduler import Scheduler as JScheduler
from vptq_tpu.utils import memory as jhbm
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu_torch.convert import convert_shard
from vptq_tpu_torch.layers import runtime as trt
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.parallel import tp
from vptq_tpu_torch.parallel.mesh import Mesh
from vptq_tpu_torch.utils import memory as thbm

LLAMA = dict(TINY, tie_word_embeddings=False)
LLAMA4 = dict(LLAMA, num_key_value_heads=4)  # 4 KV heads for 4 ranks
QWEN = dict(LLAMA, model_type="qwen2", rope_theta=1e6, rms_norm_eps=1e-6)
PHI3 = dict(LLAMA4, model_type="phi3")
MIXTRAL = dict(LLAMA, model_type="mixtral", num_local_experts=4,
               num_experts_per_tok=2)
# tests/test_deepseek.py's geometry: q_lora, grouped routing, interleave,
# a dense first layer, a tied head
DEEPSEEK = dict(
    model_type="deepseek_v3", vocab_size=256, hidden_size=64,
    intermediate_size=96, num_hidden_layers=3, num_attention_heads=4,
    num_key_value_heads=4, head_dim=16, q_lora_rank=24, kv_lora_rank=16,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    rope_interleave=True, moe_intermediate_size=32, n_routed_experts=8,
    num_experts_per_tok=2, n_shared_experts=1, n_group=4, topk_group=2,
    norm_topk_prob=True, routed_scaling_factor=2.5, first_k_dense_replace=1,
    tie_word_embeddings=True,
)
FORMATS = ("int8", "int4", "int3", "int2", "bf16")
PROMPT = [[1, 7, 42, 9, 100, 3, 77, 18, 240, 5, 61, 33]]
# (name, config, checkpoint writer's extras, format, data axis, prefill
# tokens, the tests it takes part in)
CASES = {
    2: [
        *((f"llama-{f}", LLAMA, {}, f, 1, PROMPT,
           {"place": f in ("int8", "int4", "bf16"), "estimate": True,
            "generate": f == "int8", "schedule": f == "int8"})
          for f in FORMATS),
        ("qwen2-int8", QWEN, {"qkv_bias": True}, "int8", 1, PROMPT,
         {"place": True}),
        ("phi3-int8", PHI3, {}, "int8", 1, PROMPT, {"place": True}),
        # more than _MOE_FAST_MAX_TOKENS (64) tokens: every local expert on
        # every token (K6); then one token a row: the pairs (K5)
        *((f"mixtral-{f}", MIXTRAL, {}, f, 1,
           [list(range(3, 83))], {"place": f == "int4", "ep": f == "int8"})
          for f in ("int8", "int4")),
        ("mixtral-int4-decode", MIXTRAL, {}, "int4", 1, PROMPT, {}),
        ("deepseek-int8", DEEPSEEK, {}, "int8", 1, PROMPT, {"place": True}),
    ],
    4: [
        *((f"llama4-{f}", LLAMA4, {}, f, 1, PROMPT,
           {"place": f in ("int4", "bf16")}) for f in FORMATS),
        # DP x TP: 2 sequences over the data axis, 2 ranks of TP each
        ("llama-dp2-int8", LLAMA, {}, "int8", 2,
         [PROMPT[0], list(range(20, 32))], {"place": True}),
    ],
}
GENERATE = [5, 19, 200, 3, 44, 7]
SCHEDULE = [([5, 19, 200, 3], 6), ([9, 9, 2, 77, 130, 4, 8], 5),
            ([100, 101], 7)]


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


_CHECKPOINTS = {}  # one JAX-written checkpoint per (root, config, extras)


def _checkpoint(root, cfg, extra):
    key = (str(root), repr(sorted(cfg.items())), repr(sorted(extra.items())))
    if key not in _CHECKPOINTS:
        path = root / f"ckpt{len(_CHECKPOINTS)}"
        jsc.write_synthetic_checkpoint(str(path), jsc.tiny_model_config(**cfg),
                                       vq_kwargs=VQ, seed=17, **extra)
        _CHECKPOINTS[key] = str(path)
    return _CHECKPOINTS[key]


def _shards(model, mesh) -> dict:
    """{tree path: the leaf's per-device numpy arrays in the mesh's device
    order} of a placed JAX model."""
    order = {d: i for i, d in enumerate(mesh.devices.flat)}
    flat = jax.tree_util.tree_flatten_with_path(model)[0]
    names = list(jax_params(model))
    out = {}
    for name, (_, leaf) in zip(names, flat):
        shards = sorted(leaf.addressable_shards, key=lambda s: order[s.device])
        out[name] = [np.asarray(s.data) for s in shards]
    return out


def _jax_side(root, world, case):
    name, cfg, extra, fmt, data, tokens, _ = case
    ckpt = _checkpoint(root, cfg, extra)
    mesh = j_make_mesh(data=data, model=world // data,
                       devices=np.asarray(jax.devices()[:world]))
    model = j_load_model(ckpt, runtime_format=fmt, dtype=jnp.float32,
                         mesh=mesh, parallel="tp")
    specs = jtp.tp_specs(model)
    toks = jnp.asarray(tokens, jnp.int32)
    cache = jtp.shard_cache_tp(
        j_init_cache(model.cfg, toks.shape[0], 128, jnp.float32), mesh)
    with mesh:
        logits, cache = jtp.forward_tp(model, toks, cache, specs, mesh,
                                       dtype=jnp.float32, fresh_prefill=True)
        nxt = jnp.asarray([[11 + i] for i in range(toks.shape[0])], jnp.int32)
        step, _ = jtp.forward_tp(model, nxt, cache, specs, mesh,
                                 dtype=jnp.float32)
    out = dict(ckpt=ckpt, fmt=fmt, mesh=mesh, model=model,
               logits=np.asarray(logits), step=np.asarray(step),
               shards=_shards(model, mesh),
               hf_config=_hf_config(ckpt))
    if case[6].get("place"):
        one = j_load_model(ckpt, runtime_format=fmt, dtype=jnp.float32)
        placed, _ = jtp.tp_place_model(one, mesh)
        out["placed"] = _shards(placed, mesh)
    return out


def _hf_config(ckpt) -> dict:
    with open(f"{ckpt}/config.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_pallas):
    """{world: (the JAX side of each case, each rank's results)}."""
    root = tmp_path_factory.mktemp("tp")
    out = {}
    for world, cases in CASES.items():
        jax_side, spec = {}, []
        for case in cases:
            name, _, _, _, data, tokens, flags = case
            jax_side[name] = _jax_side(root, world, case)
            spec.append(dict(
                name=name, ckpt=jax_side[name]["ckpt"], fmt=case[3],
                data=data, tokens=tokens,
                next=[[11 + i] for i in range(len(tokens))],
                place=flags.get("place", False),
                estimate=flags.get("estimate", False),
                ep=flags.get("ep", False),
                generate=GENERATE if flags.get("generate") else None,
                schedule=SCHEDULE if flags.get("schedule") else None,
            ))
        torch.save(spec, root / f"spec{world}.pt")
        spawn_ranks(tp_rank_cases, world, root, str(root / f"spec{world}.pt"),
                    str(root))
        ranks = [torch.load(root / f"{r}.pt") for r in range(world)]
        out[world] = (jax_side, ranks)
    return out


def _cases(world, flag=None):
    return [(world, c[0]) for c in CASES[world]
            if flag is None or c[6].get(flag)]


ALL = _cases(2) + _cases(4)


def _state_bytes(model) -> dict:
    return {k: v.contiguous().view(torch.uint8)
            for k, v in model.state_dict().items()}


def _assert_same_bytes(got: dict, want: dict, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert torch.equal(got[k], want[k]), f"{what}: {k}"


@pytest.mark.parametrize("world,name", ALL)
def test_sharded_load_is_jax_device_shard(runs, world, name):
    """Each rank's ``load_model(mesh=)`` shard byte-equal to device
    ``rank``'s arrays of JAX's ``load_model(mesh=, parallel="tp")``."""
    jax_side, ranks = runs[world]
    j = jax_side[name]
    for rank, res in enumerate(ranks):
        want = convert_shard(j["shards"], j["hf_config"], rank, device="cpu")
        _assert_same_bytes(res[name]["bytes"], _state_bytes(want),
                           f"{name} rank {rank}")


@pytest.mark.parametrize("world,name", _cases(2, "place") + _cases(4, "place"))
def test_placement_is_jax_device_shard(runs, world, name):
    """``tp_place_model`` of a one-device load byte-equal to JAX's
    ``tp_place_model`` of its one-device load, device by device (the
    row-parallel layers re-encoded blocked from the one-device codes)."""
    jax_side, ranks = runs[world]
    j = jax_side[name]
    for rank, res in enumerate(ranks):
        want = convert_shard(j["placed"], j["hf_config"], rank, device="cpu")
        _assert_same_bytes(res[name]["placed"], _state_bytes(want),
                           f"{name} rank {rank}")


def test_bf16_sharded_load_equals_placing_a_one_device_load(runs):
    """bf16 has no blocked encoding: the sharded load is the one-device
    load placed."""
    for world, name in (2, "llama-bf16"), (4, "llama4-bf16"):
        for res in runs[world][1]:
            _assert_same_bytes(res[name]["bytes"], res[name]["placed"], name)


def _rows(world, name, rank, logits):
    """JAX's logits rows of this rank (its data rank's batch rows)."""
    data = next(c[4] for c in CASES[world] if c[0] == name)
    if data == 1:
        return logits
    b = logits.shape[0] // data
    d = rank // (world // data)
    return logits[d * b: (d + 1) * b]


# The cases whose rows pass 1e-4 of max |logit|, each with the rows it
# needs past it and their bound. Both packages round activations to bf16
# inside every kernel: an activation whose last f32 bit differs across a
# rounding edge moves one product by 2^-9 of itself (2e-3 bounds that
# row), and in a MoE block, where that tips a router's near tie, the row
# takes another expert (1e-2). Every other case, and every decode step,
# is held to 1e-4.
ROUNDING_EDGE = {
    # the one-device port meets such rows against JAX on this prompt too
    # (int8: 3 of 80, up to 7.1e-3; int4: 1 of 80, 1.3e-3)
    (2, "mixtral-int8", "logits"): (2, 1e-2),
    (2, "mixtral-int4", "logits"): (2, 1e-2),
    # one row of 12 at 7.3e-4: the same with the ranks' partials summed in
    # rank order in f32 as with the backend's all-reduce, so not the
    # collective's order; the one-device port on this prompt has none
    (4, "llama4-int8", "logits"): (1, 2e-3),
}


def _assert_logits_close(got, want, allowed):
    """Every row within 1e-4 of max |logit| of JAX's but ``allowed``:
    (rows that may pass it, their bound)."""
    rows, cap = allowed
    scale = np.abs(want).max()
    err = np.abs(got - want).reshape(-1, want.shape[-1]).max(axis=-1)
    assert err.max() <= cap * scale, err.max() / scale
    loose = int((err > 1e-4 * scale).sum())
    assert loose <= rows, (loose, len(err), err.max() / scale)


@pytest.mark.parametrize("world,name", ALL)
def test_forward_tp_logits_match_jax(runs, world, name):
    jax_side, ranks = runs[world]
    j = jax_side[name]
    for key in ("logits", "step"):
        for rank, res in enumerate(ranks):
            want = _rows(world, name, rank, j[key])
            got = res[name][key].numpy()
            assert got.shape == want.shape, (key, got.shape, want.shape)
            _assert_logits_close(
                got, want, ROUNDING_EDGE.get((world, name, key), (0, 1e-4)))
        # every rank of a data row holds the same vocabulary-complete rows
        for rank in range(world):
            peer = rank ^ 1 if world // j["mesh"].shape["data"] > 1 else rank
            assert torch.equal(ranks[rank][name][key], ranks[peer][name][key])


@pytest.mark.parametrize("fmt", ["int8", "int4", "int3", "int2", "bf16"])
def test_placed_bytes_match_the_estimate(runs, fmt):
    """The sum of the ranks' placed bytes against ``estimate_model_bytes(
    tp_shards=2)``, within JAX's 2% (``tests/test_tp.py``); the estimate is
    JAX's integer."""
    j = runs[2][0][f"llama-{fmt}"]
    qcfg = j["hf_config"]["quantization_config"]
    from vptq_tpu_torch.config import QuantizationConfig
    from vptq_tpu_torch.models.llama import ModelConfig

    cfg = ModelConfig.from_hf_dict(j["hf_config"])
    est = thbm.estimate_model_bytes(
        cfg, fmt, QuantizationConfig.from_dict(qcfg), tp_shards=2)["total"]
    assert est == jhbm.estimate_model_bytes(
        j["model"].cfg, fmt, JQuantizationConfig.from_dict(qcfg),
        tp_shards=2)["total"]
    actual = sum(r[f"llama-{fmt}"]["model_bytes"] for r in runs[2][1])
    assert abs(actual - est) / actual < 0.02, (actual, est)


def test_generator_and_scheduler_tokens_match_jax(runs, jax_pallas):
    jax_side, ranks = runs[2]
    j = jax_side["llama-int8"]
    mesh, model = j["mesh"], j["model"]
    gen = JGenerator(model, max_seq=64, dtype=jnp.float32,
                     prompt_buckets=(16, 32), mesh=mesh)
    want = gen.generate(GENERATE, max_new_tokens=8, chunk_size=4)
    sched = JScheduler(model, max_batch=2, max_seq=64, dtype=jnp.float32,
                       chunk=4, prompt_buckets=(16, 32), mesh=mesh)
    ids = [sched.submit(p, max_new_tokens=n) for p, n in SCHEDULE]
    outs = sched.run()
    served = [outs[i] for i in ids]
    for res in ranks:
        r = res["llama-int8"]
        assert r["greedy"] == want
        assert r["served"] == served
        assert r["decode_mode"] == "eager"  # CPU: no graphs


def test_sampling_is_the_same_on_every_rank_and_run(runs):
    ranks = runs[2][1]
    first = ranks[0]["llama-int8"]["sampled"]
    assert first[0] == first[1]
    assert len(first[0]) == 8
    for res in ranks[1:]:
        assert res["llama-int8"]["sampled"] == first


def test_moe_forward_ep_is_the_routed_experts(runs):
    """``moe_forward_ep`` over each rank's ``shard_stacked_experts`` equals
    the one-device routed experts (both paths; f32, one sum of two
    partials)."""
    for res in runs[2][1]:
        assert res["mixtral-int8"]["ep_gap"] <= 1e-5


def test_shard_cache_tp_takes_heads_and_rows():
    """A rank's cache: its KV heads (a latent cache of one head whole), its
    batch rows when they ride the data axis, shaped as ``init_cache_tp``
    makes it."""
    from vptq_tpu_torch.models.llama import ModelConfig, init_cache

    cfg = ModelConfig(**{k: v for k, v in LLAMA4.items()
                         if k != "tie_word_embeddings"})
    whole = init_cache(cfg, 4, 16, torch.float32, "cpu")
    for i, (k, v) in enumerate(zip(whole.k, whole.v)):
        k.copy_(torch.arange(k.numel(), dtype=torch.float32).reshape(k.shape))
        v.copy_(-k)
    whole.lengths.copy_(torch.tensor([1, 2, 3, 4]))
    for rank in range(4):
        mesh = Mesh(data=2, model=2, rank=rank)
        got = tp.shard_cache_tp(whole, mesh)
        like = tp.init_cache_tp(cfg, 4, 16, torch.float32, mesh)
        assert got.k[0].shape == like.k[0].shape == (2, 16, 2, 16)
        rows = slice(2 * mesh.data_rank, 2 * mesh.data_rank + 2)
        heads = slice(2 * mesh.model_rank, 2 * mesh.model_rank + 2)
        assert torch.equal(got.k[1], whole.k[1][rows, :, heads])
        assert torch.equal(got.lengths, whole.lengths[rows])
    assert tp.batch_axis(Mesh(data=2, model=2), 3) is None
    assert tp.batch_axis(Mesh(data=2, model=2), 4) == "data"


# ------------------------------------------------------------- refusals


def _one_device(root, cfg=LLAMA, fmt="int8"):
    ckpt = _checkpoint(root, cfg, {})
    return ckpt, load_model(ckpt, dtype=torch.float32, runtime_format=fmt,
                            device="cpu")


def _message(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e), str(e)
    raise AssertionError("no refusal")


def test_divisibility_refusals_are_jax_messages(tmp_path):
    _, model = _one_device(tmp_path)
    got = _message(lambda: tp.tp_place_model(model, Mesh(data=1, model=3)))
    want = _message(lambda: jtp.tp_validate(
        jsc.tiny_model_config(**LLAMA), 3))
    assert got == want
    assert "does not divide TP size 3" in got[1]
    _, mix = _one_device(tmp_path, dict(MIXTRAL, num_local_experts=3), "int8")
    with pytest.raises(NotImplementedError, match="must divide TP size 2"):
        tp.tp_place_model(mix, Mesh(data=1, model=2))


def test_row_parallel_bias_is_refused_with_jax_message():
    w = torch.zeros(8, 64)
    layer = trt._encode_int8(w, torch.ones(8))
    got = _message(lambda: tp._row_parallel(layer, Mesh(data=1, model=2), 64))
    from vptq_tpu.layers import runtime as jrt

    jlayer = jrt._encode_int8(np.zeros((8, 64), np.float32),
                              np.ones(8, np.float32))
    want = _message(lambda: jtp._row_parallel(jlayer, None, "model", 2, 64))
    assert got == want


def test_codebook_and_mixed_formats_are_refused_under_a_mesh(tmp_path):
    """``load_model(mesh=)`` places the codebook format as the JAX
    package's GSPMD placement splits it (rank 0's shard here: its layers'
    index planes halved; ``tests/test_torch_tp_codebook.py`` holds the
    ranks' logits), while ``from_pretrained(tp=)`` keeps the JAX
    package's refusal of it."""
    ckpt, _ = _one_device(tmp_path)
    mesh = Mesh(data=1, model=2)
    one = load_model(ckpt, runtime_format="codebook", dtype=torch.float32,
                     device="cpu")
    placed = load_model(ckpt, runtime_format="codebook", mesh=mesh,
                        dtype=torch.float32)
    q, o = one.blocks[0].attn.q_proj, one.blocks[0].attn.o_proj
    pq, po = placed.blocks[0].attn.q_proj, placed.blocks[0].attn.o_proj
    assert pq.ids.shape[1] * 2 == q.ids.shape[1]
    assert isinstance(po, tp.VQRowShard)
    assert po.layer.ids.shape[2] * 2 == o.ids.shape[2]
    from vptq_tpu_torch.api import AutoModelForCausalLM

    with pytest.raises(ValueError, match="codebook"):
        AutoModelForCausalLM.from_pretrained(ckpt, runtime_format="codebook",
                                             tp=2, device="cpu")


def test_a_row_parallel_mixed_layer_to_reencode_is_refused():
    """JAX's message: a mixed layer comes blocked from calibration."""
    w = torch.randn(8, 256)
    base = trt._encode_int2(w, None)
    side = trt.int8_from_q(torch.ones(8, 128, dtype=torch.int8),
                           torch.ones(8, 1))
    layer = trt.Int2MixedLinear(base, side, torch.arange(128,
                                                         dtype=torch.int32))
    got = _message(lambda: tp._row_parallel(layer, Mesh(data=1, model=2),
                                            256))
    from vptq_tpu.layers import runtime as jrt

    jbase = jrt._encode_int2(np.zeros((8, 256), np.float32), None)
    jside = jrt.int8_from_q(np.ones((8, 128), np.int8),
                            np.ones((8, 1), np.float32), None)
    jlayer = jrt.Int2MixedLinear(int2=jbase, int8=jside,
                                 col_idx=jnp.arange(128, dtype=jnp.int32),
                                 bias=None)
    want = _message(lambda: jtp._row_parallel(jlayer, None, "model", 2, 256))
    assert got == want
