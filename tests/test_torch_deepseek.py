"""vptq_tpu_torch's DeepSeek-V3 path against vptq_tpu.

Tiny DeepSeek-V3 checkpoints (3 layers of width 64, the first dense, 8
experts in 4 groups, top 2 of the 2 best groups, one shared expert) go
through both packages from the same numpy-seeded weights; JAX runs its
Pallas kernels in interpret mode (its other path does not round
activations to bf16, as the kernels do) and its numpy encoders.

* The synthetic writer's tensors are JAX's, byte for byte.
* ``absorb_mla``'s uk / uv are JAX's, bit for bit (f32 and bf16 loads).
* ``rope_frequencies`` at ``rope_dim`` (yarn's ``mscale_all_dim``
  included), ``apply_rope`` interleaved and not, and MLA's softmax scale.
* The grouped sigmoid router picks JAX's experts and weights, with ties
  constructed in the group pick and the expert pick and choices below
  the 0.0 that masks a dropped group.
* ``_deepseek_moe``'s selected-experts path equals its all-experts path
  and JAX's.
* Logits exact up to the first bf16 rounding edge inside a kernel and
  within 1e-2 of max past it (see ``_assert_logits_close``), greedy
  tokens equal to JAX's ``Generator``, in int8, int4 and bf16, across
  the q_lora and q_proj layouts, with and without interleave, with yarn's
  mscale.
* ``convert_params`` of a JAX tree gives the loader's model.
* The ``Scheduler`` gives the port's ``Generator``'s tokens, prefix hits
  included; ``from_pretrained`` serves the model.
"""

import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import torch
from torch_port import VQ, jax_params

from vptq_tpu import native
from vptq_tpu.layers import runtime as jrt
from vptq_tpu.models import llama as jl
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.serving.generate import Generator as JGenerator
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu_torch import AutoModelForCausalLM
from vptq_tpu_torch.convert import convert_params
from vptq_tpu_torch.layers import runtime as trt
from vptq_tpu_torch.models import llama as tl
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.serving.generate import Generator
from vptq_tpu_torch.serving.prefix_cache import PrefixCache
from vptq_tpu_torch.serving.scheduler import Scheduler
from vptq_tpu_torch.utils import synth_checkpoint as tsc

# tests/test_deepseek.py's geometry: q_lora, grouped routing, interleave
DS_CFG = dict(
    model_type="deepseek_v3", vocab_size=256, hidden_size=64,
    intermediate_size=96, num_hidden_layers=3, num_attention_heads=4,
    num_key_value_heads=4, head_dim=16, q_lora_rank=24, kv_lora_rank=16,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    rope_interleave=True, moe_intermediate_size=32, n_routed_experts=8,
    num_experts_per_tok=2, n_shared_experts=1, n_group=4, topk_group=2,
    norm_topk_prob=True, routed_scaling_factor=2.5, first_k_dense_replace=1,
    tie_word_embeddings=True,
)
YARN = {"rope_type": "yarn", "factor": 4.0, "beta_fast": 32, "beta_slow": 1,
        "mscale": 1.0, "mscale_all_dim": 1.0,
        "original_max_position_embeddings": 16}
# the layouts: q_lora with interleave; q_proj (Moonlight's) without
# interleave, one group, an untied head; q_lora with yarn's mscale
VARIANTS = {
    "q_lora": dict(DS_CFG),
    "q_proj": dict(DS_CFG, q_lora_rank=None, rope_interleave=False,
                   n_group=1, topk_group=1, num_experts_per_tok=3,
                   n_shared_experts=2, tie_word_embeddings=False),
    "yarn": dict(DS_CFG, rope_scaling=tuple(sorted(YARN.items())),
                 max_position_embeddings=64),
}


@pytest.fixture(scope="module", autouse=True)
def jax_pallas():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_lib", lambda: None)
        mp.setattr(sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL", "pallas")
        mp.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
        yield
        # jit caches are keyed on shapes, not on the switch: a trace
        # made here would serve a later test at the same shapes on
        # the XLA path
        jax.clear_caches()


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("deepseek"))


@functools.lru_cache(maxsize=None)
def _checkpoint(root: str, variant: str) -> str:
    """JAX's writer's checkpoint of one variant; yarn goes into config.json
    as JAX's own DeepSeek test puts it there."""
    cfg = dict(VARIANTS[variant])
    scaling = cfg.pop("rope_scaling", None)
    path = f"{root}/{variant}"
    jsc.write_synthetic_checkpoint(
        path, jsc.tiny_model_config(**cfg), vq_kwargs=VQ, seed=101)
    if scaling is not None:
        with open(f"{path}/config.json") as f:
            conf = json.load(f)
        conf["rope_scaling"] = dict(scaling)
        with open(f"{path}/config.json", "w") as f:
            json.dump(conf, f)
    return path


@functools.lru_cache(maxsize=None)
def _models(root: str, variant: str, fmt: str):
    path = _checkpoint(root, variant)
    return (
        j_load_model(path, dtype=jnp.float32, runtime_format=fmt),
        load_model(path, dtype=torch.float32, runtime_format=fmt,
                   device="cpu"),
    )


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _assert_rows_close(got, want):
    """1e-4 of max |value|, but for a few rows 2e-3: both packages round
    activations to bf16 inside every kernel, so an activation that differs
    in its last f32 bit across a bf16 rounding edge moves one product by
    2^-9 of itself (``tests/test_torch_moe.py``)."""
    scale = np.abs(want).max()
    err = np.abs(got - want).reshape(-1, want.shape[-1]).max(axis=-1)
    assert err.max() <= 2e-3 * scale, err.max() / scale
    loose = int((err > 1e-4 * scale).sum())
    assert loose <= max(1, len(err) // 10), (loose, len(err))


def _assert_logits_close(got, want):
    """A prompt's logits: exact (1e-5 of max |logit|) up to the first
    position where one kernel's bf16 rounding of an activation falls on
    the other side of an edge (an f32 last-bit difference upstream: the
    uk / uv and attention sums run in another order), every row within
    1e-2 of max from there (``tests/test_torch_phi3.py``'s int4 bound):
    that position's latent key and value reach every later query, so the
    one-ulp move spreads over the rest of the prompt, not to a few rows
    as in Mixtral's attention of 8 dims a head less than MLA's products
    carry. The greedy tokens are held exactly beside it."""
    scale = np.abs(want).max()
    err = np.abs(got - want).reshape(-1, want.shape[-1]).max(axis=-1)
    assert err.max() <= 1e-2 * scale, err.max() / scale
    first = int(np.argmax(err > 1e-5 * scale)) if (err > 1e-5 * scale).any(
    ) else len(err)
    assert first >= 1 and (err[:first] <= 1e-5 * scale).all()


def _logits(jmodel, tmodel, tokens, max_seq=96):
    want, _ = jl.forward(
        jmodel, jnp.asarray(tokens, jnp.int32),
        jl.init_cache(jmodel.cfg, 1, max_seq, jnp.float32), dtype=jnp.float32,
    )
    with torch.inference_mode():
        got, _ = tl.forward(
            tmodel, torch.from_numpy(tokens),
            tl.init_cache(tmodel.cfg, 1, max_seq, torch.float32, "cpu"),
            dtype=torch.float32,
        )
    return got.numpy(), np.asarray(want)


# ----------------------------------------------------------------- writer


@pytest.mark.parametrize("variant", ["q_lora", "q_proj"])
def test_synthetic_deepseek_checkpoint_equals_jax_writer(tmp_path, variant):
    cfg = VARIANTS[variant]
    jsc.write_synthetic_checkpoint(
        tmp_path / "jax", jsc.tiny_model_config(**cfg), vq_kwargs=VQ, seed=3)
    tsc.write_synthetic_checkpoint(
        tmp_path / "port", tsc.tiny_model_config(**cfg), vq_kwargs=VQ,
        seed=3)
    want = safetensors.numpy.load_file(tmp_path / "jax" / "model.safetensors")
    got = safetensors.numpy.load_file(tmp_path / "port" / "model.safetensors")
    assert sorted(got) == sorted(want)
    assert "model.layers.2.mlp.experts.7.down_proj.indices" in got
    assert "model.layers.1.mlp.gate.e_score_correction_bias" in got
    assert "model.layers.0.mlp.gate.weight" not in got  # the dense layer
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(got[name], arr, err_msg=name)

    def config(side):
        with open(tmp_path / side / "config.json") as f:
            return json.load(f)

    jconf, tconf = config("jax"), config("port")
    assert {k: jconf[k] for k in tconf} == tconf
    assert tconf["architectures"] == ["DeepseekV3ForCausalLM"]
    assert tconf["q_lora_rank"] == cfg["q_lora_rank"]
    assert tl.ModelConfig.from_hf_dict(tconf) == tsc.tiny_model_config(**cfg)


# ------------------------------------------------------------- absorb_mla


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absorbed_uk_uv_are_jax_bits(workdir, dtype):
    path = _checkpoint(workdir, "q_lora")
    jmodel = j_load_model(path, dtype=getattr(jnp, dtype),
                          runtime_format="int8")
    tmodel = load_model(path, dtype=getattr(torch, dtype),
                        runtime_format="int8", device="cpu")
    for jb, tb in zip(jmodel.blocks, tmodel.blocks):
        assert isinstance(tb.attn, tl.MlaAttention)
        for name in ("uk", "uv"):
            want, got = getattr(jb.attn, name), getattr(tb.attn, name)
            assert tuple(got.shape) == want.shape == (16, 4, 16)
            assert str(got.dtype).endswith(dtype)
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=name)
    # the raw kv_b_proj is absorbed, never kept
    assert not any("kv_b" in n for n, _ in tmodel.named_modules())


# ------------------------------------------------------------------- RoPE


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_rope_at_rope_dim_matches_jax(variant):
    cfg = VARIANTS[variant]
    jcfg, tcfg = jsc.tiny_model_config(**cfg), tsc.tiny_model_config(**cfg)
    assert tcfg.rope_dim == jcfg.rope_dim == 8
    assert (tcfg.cache_k_dim, tcfg.cache_v_dim) == (24, 16)
    want_f, want_s = jl.rope_frequencies(jcfg)
    got_f, got_s = tl.rope_frequencies(tcfg, "cpu")
    assert got_f.shape == (4,)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=1e-6)
    assert got_s == pytest.approx(want_s, rel=1e-12)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    pos = rng.integers(0, 60, (2, 5))
    jcos, jsin = jl.rope_cos_sin(jnp.asarray(pos), want_f, want_s)
    cos, sin = tl.rope_cos_sin(torch.from_numpy(pos), got_f, got_s)
    for interleaved in (False, True):
        want = np.asarray(jl.apply_rope(jnp.asarray(x), jcos, jsin,
                                        interleaved))
        got = tl.apply_rope(torch.from_numpy(x), cos, sin, interleaved)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # DeepseekV3Attention's softmax scale: yarn's mscale, squared
    scale = tl.mla_softmax_scale(tcfg)
    mscale = 0.1 * np.log(4.0) + 1.0 if variant == "yarn" else 1.0
    assert scale == pytest.approx(24 ** -0.5 * mscale ** 2, rel=1e-12)


def test_missing_rope_interleave_reads_false_as_jax_does():
    hf = {k: v for k, v in DS_CFG.items() if k != "rope_interleave"}
    assert tl.ModelConfig.from_hf_dict(hf).rope_interleave is False
    assert jl.ModelConfig.from_hf_dict(hf).rope_interleave is False


# ----------------------------------------------------------------- router


def _moe_pair(rng, fmt, router, bias, n_group, topk_group, top_k, hidden=64,
              inter=32):
    """One DeepSeek MoE block in both packages from the same numpy
    weights: experts encoded by each package's encoder and stacked, a
    shared expert of bf16 weights."""
    n = router.shape[0]
    jenc, tenc = getattr(jrt, f"_encode_{fmt}"), getattr(trt, f"_encode_{fmt}")
    weights = [((0.05 * rng.standard_normal((2 * inter, hidden))).astype(
        np.float32), (0.05 * rng.standard_normal((hidden, inter))).astype(
        np.float32)) for _ in range(n + 1)]
    jexperts = [jl.Mlp(gate_proj=None, up_proj=None, down_proj=jenc(d, None),
                       gate_up_proj=jenc(gu, None)) for gu, d in weights]
    texperts = [tl.Mlp(None, None, tenc(torch.from_numpy(d), None),
                       tenc(torch.from_numpy(gu), None)) for gu, d in weights]
    kw = dict(top_k=top_k, n_group=n_group, topk_group=topk_group,
              norm_topk_prob=True, routed_scaling_factor=2.5)
    jmoe = jl.DeepseekMoe(
        router_weight=jnp.asarray(router), correction_bias=jnp.asarray(bias),
        experts=(), shared_experts=jexperts[n],
        stacked=jax.tree_util.tree_map(
            jnp.asarray, jrt.stack_experts(jexperts[:n])), **kw)
    tmoe = tl.DeepseekMoe(
        torch.from_numpy(router), torch.from_numpy(bias), [],
        texperts[n], stacked=trt.stack_experts(texperts[:n]), **kw)
    return jmoe, tmoe


def _routed(monkeypatch):
    """The (ids, weights) each package's router hands to its dispatch."""
    seen = {"jax": [], "port": []}
    for key, mod in (("jax", jl), ("port", tl)):
        real = mod._route_moe

        def spy(x, ids, w, *args, _real=real, _key=key):
            seen[_key].append((np.asarray(ids), np.asarray(w)))
            return _real(x, ids, w, *args)

        monkeypatch.setattr(mod, "_route_moe", spy)
    return seen


def test_grouped_router_picks_jax_experts_with_ties(monkeypatch):
    """8 experts in 4 groups of 2, the 2 best groups kept, top 4. Group 2
    is a copy of group 0 (their scores tie: group 0 is kept), experts 2
    and 3 are copies (a tie in the expert pick: 2 first), expert 1 (and
    its copy 5) and group 3 carry biases that push their choices below 0:
    so the fourth pick is a dropped group's expert at the 0.0 that masks
    it (the lowest id, 4), not the kept expert 1, as it would be under a
    -inf mask. The ids are JAX's, and so are the weights and outputs
    (within the logits' allowance)."""
    rng = np.random.default_rng(31)
    rows = (0.5 * rng.standard_normal((3, 64))).astype(np.float32)
    router = rows[[0, 1, 2, 2, 0, 1, 1, 2]]
    bias = np.array([0.0, -2.0, 0.3, 0.3, 0.0, -2.0, -2.5, -2.5], np.float32)
    jmoe, tmoe = _moe_pair(rng, "int8", router, bias, n_group=4,
                           topk_group=2, top_k=4)
    x = rng.standard_normal((1, 40, 64)).astype(np.float32)
    seen = _routed(monkeypatch)
    want = np.asarray(jl._deepseek_moe(jmoe, jnp.asarray(x)))
    got = tl._deepseek_moe(tmoe, torch.from_numpy(x)).numpy()
    (jids, jw), (tids, tw) = seen["jax"][0], seen["port"][0]
    np.testing.assert_array_equal(tids, jids)
    # f32 scores of x @ router.T, summed in another order
    np.testing.assert_allclose(tw, jw, rtol=1e-5)
    ids = tids.reshape(-1, 4).tolist()
    for row in ids:
        assert sorted(row) == [0, 2, 3, 4] and row[-1] == 4, row
        assert row.index(2) < row.index(3)
    # the kernels round their activations to bf16: the MoE allowance
    _assert_rows_close(got, want)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_deepseek_moe_fast_path_equals_dense_path_and_jax(monkeypatch, fmt):
    """Top 2 of 8 in 4 groups at widths both encoders pad (experts 32 →
    512 / 2048): the selected-experts path (K5) and the all-experts path
    (K6) of the port equal each other and JAX's, routed experts and
    shared expert summed."""
    rng = np.random.default_rng(12)
    router = (0.5 * rng.standard_normal((8, 64))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(8)).astype(np.float32)
    jmoe, tmoe = _moe_pair(rng, fmt, router, bias, 4, 2, 2)
    x = rng.standard_normal((1, 6, 64)).astype(np.float32)
    calls = {"expert": 0, "pairs": 0}
    for kind, table in (("expert", tl._EXPERT_MATMUL),
                        ("pairs", tl._PAIRS_MATMUL)):
        fn = table[fmt]

        def counted(*a, _fn=fn, _kind=kind, **k):
            calls[_kind] += 1
            return _fn(*a, **k)

        monkeypatch.setitem(table, fmt, counted)
    fast = tl._deepseek_moe(tmoe, torch.from_numpy(x)).numpy()
    want_fast = np.asarray(jl._deepseek_moe(jmoe, jnp.asarray(x)))
    assert calls == {"expert": 0, "pairs": 2}
    monkeypatch.setattr(tl, "_MOE_FAST_MAX_TOKENS", 0)
    monkeypatch.setattr(jl, "_MOE_FAST_MAX_TOKENS", 0)
    dense = tl._deepseek_moe(tmoe, torch.from_numpy(x)).numpy()
    want_dense = np.asarray(jl._deepseek_moe(jmoe, jnp.asarray(x)))
    assert calls == {"expert": 16, "pairs": 2}
    tol = 1e-5 * np.abs(want_dense).max()
    np.testing.assert_allclose(fast, want_fast, rtol=1e-5, atol=tol)
    np.testing.assert_allclose(dense, want_dense, rtol=1e-5, atol=tol)
    np.testing.assert_allclose(fast, dense, rtol=1e-5, atol=tol)


# ------------------------------------------------------------- end to end


# (variant, format, prompt length, max_seq): 70 tokens take every expert
# on every token (K6) in the prefill, 14 (bucket 16) the selected experts
# (K5); JAX's int4 kernels in interpret mode are the slow part, so the
# second int4 case takes the short prompt; yarn changes no kernel's input
# shape; a cache of 256 positions decodes block by block (one latent head
# under 4 query heads), 96 over the live prefix
E2E = [
    ("q_lora", "int8", 70, 96), ("q_lora", "int4", 70, 96),
    ("q_lora", "bf16", 70, 96), ("q_proj", "int8", 70, 96),
    ("q_proj", "int4", 14, 96), ("q_proj", "bf16", 70, 96),
    ("yarn", "bf16", 70, 96), ("q_lora", "bf16", 70, 256),
]


@pytest.mark.parametrize("variant,fmt,n,max_seq", E2E)
def test_deepseek_logits_and_greedy_tokens_identical(workdir, variant, fmt,
                                                     n, max_seq):
    """A prompt's logits, then greedy tokens through both Generators (the
    prompt, and its first 9 tokens), decode through the selected experts
    (K5), the latent cache crossing the prompt's bucket."""
    jmodel, tmodel = _models(workdir, variant, fmt)
    mlp = tmodel.blocks[1].mlp
    assert isinstance(tmodel.blocks[0].mlp, tl.Mlp)
    assert isinstance(mlp, tl.DeepseekMoe)
    assert (mlp.stacked is not None) == (fmt != "bf16")
    assert mlp.shared_experts.gate_up_proj is not None  # fused
    assert tl.takes_blocks(max_seq) == (max_seq == 256)
    cache = tl.init_cache(tmodel.cfg, 1, max_seq, torch.float32, "cpu")
    assert cache.k[0].shape == (1, max_seq, 1, 24)
    assert cache.v[0].shape == (1, max_seq, 1, 16)

    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 256, n)
    got, want = _logits(jmodel, tmodel, prompt[None, :], max_seq)
    _assert_logits_close(got, want)

    new, buckets = 8, (16, 80)
    jgen = JGenerator(jmodel, max_seq=max_seq, dtype=jnp.float32,
                      prompt_buckets=buckets)
    gen = Generator(tmodel, max_seq=max_seq, dtype=torch.float32,
                    prompt_buckets=buckets)
    for p in (prompt, prompt[:9]):
        want = jgen.generate(p, max_new_tokens=new, chunk_size=4)
        got = gen.generate(p, max_new_tokens=new, chunk_size=4)
        assert len(want) == new and got == want


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_convert_params_gives_the_loaders_model(workdir, fmt):
    jmodel, loaded = _models(workdir, "q_lora", fmt)
    with open(f"{_checkpoint(workdir, 'q_lora')}/config.json") as f:
        hf = json.load(f)
    converted = convert_params(jax_params(jmodel), hf, device="cpu")
    a, b = dict(converted.named_buffers()), dict(loaded.named_buffers())
    assert a.keys() == b.keys()
    for name, t in a.items():
        np.testing.assert_array_equal(_bits(t), _bits(b[name]), err_msg=name)
    assert converted.blocks[2].mlp.stacked.fmt == fmt
    tokens = np.random.default_rng(0).integers(0, 256, (1, 7))
    outs = []
    for model in (converted, loaded):
        with torch.inference_mode():
            logits, _ = tl.forward(
                model, torch.from_numpy(tokens),
                tl.init_cache(model.cfg, 1, 16, torch.float32, "cpu"),
                dtype=torch.float32,
            )
        outs.append(logits.numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_scheduler_serves_deepseek_as_the_generator(workdir):
    """Requests through the port's Scheduler (two slots, batched decode
    through the selected experts) and its prefix cache: each one's
    tokens are the Generator's; the prompts sharing a head hit the cache.
    from_pretrained serves the same model."""
    _, tmodel = _models(workdir, "q_proj", "int4")
    head = list(np.arange(1, 18) % 200)
    requests = [(head + [30], 6), (head + [40, 41], 6), ([7, 8, 9], 5),
                (list(range(60, 90)), 7)]
    kw = dict(max_seq=64, prompt_buckets=(16, 32))
    gen = Generator(tmodel, dtype=torch.float32, **kw)
    want = [gen.generate(p, max_new_tokens=n) for p, n in requests]
    pc = PrefixCache(block_size=8)
    sched = Scheduler(tmodel, dtype=torch.float32, max_batch=2, chunk=3,
                      prefix_cache=pc, **kw)
    ids = [sched.submit(p, max_new_tokens=n) for p, n in requests]
    got = sched.run()
    assert [got[i] for i in ids] == want
    assert pc.hits >= 1
    engine = AutoModelForCausalLM.from_pretrained(
        _checkpoint(workdir, "q_proj"), runtime_format="int4",
        dtype=torch.float32, max_seq=64, device="cpu")
    assert engine.generate(requests[3][0], max_new_tokens=7) == want[3]
