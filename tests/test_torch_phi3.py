"""The loader's and the decoder's remainders against vptq_tpu: Phi-3's
fused checkpoint layout, yarn RoPE, the ``pytorch_model*.bin`` reader and
the ``VPTQ_TPU_FLASH`` switch.

* A Phi-3 checkpoint (q|k|v and gate|up stored fused) written by
  vptq_tpu's writer loads into the port's fused linears: each fused
  linear gives JAX's output to 1e-6 of max (f32 summation order), the
  logits are within 1e-4 of
  max of the JAX ``forward`` (int4: 1e-2, since its kernels round x to
  bf16 and an upstream difference in the last f32 bits moves an x element
  that sits on a bf16 rounding tie by one ulp; with JAX's input given to
  every int4 linear, 1e-4 again) and the greedy tokens are identical, in int8,
  int4 and bf16 (JAX's low-bit kernels in Pallas interpret mode, which
  round x to bf16 as the port's do). The port's writer emits the same
  tensors for the fused names, and its checkpoint loads alike in both.
* yarn: ``rope_frequencies`` equal to JAX's, ``attention_scaling`` too,
  at Qwen2.5's long-context setting and a DeepSeek-style one with
  ``mscale`` / ``mscale_all_dim``; a tiny Qwen2 with yarn gives JAX's
  greedy tokens.
* ``.bin``: one file, and shards with their index, hold the tensors of
  the safetensors read and give the same tokens.
* ``VPTQ_TPU_FLASH=0`` sends a long fresh bf16 chunk to the cache
  attention, never to K8, with JAX's tokens; ``longrope`` and ``phimoe``
  are refused.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import torch
from torch_port import TINY, VQ

from vptq_tpu import native
from vptq_tpu.layers import runtime as jrt
from vptq_tpu.models import llama as jl
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.serving.generate import Generator as JGenerator
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu_torch.layers import runtime as trt
from vptq_tpu_torch.models import llama as tl
from vptq_tpu_torch.models.loader import load_model, load_state_dict
from vptq_tpu_torch.ops.flash_attention import flash_attention
from vptq_tpu_torch.serving.generate import Generator
from vptq_tpu_torch.utils import synth_checkpoint as tsc

# Phi-3's attention: as many KV heads as query heads
PHI3 = dict(TINY, model_type="phi3", num_key_value_heads=4,
            tie_word_embeddings=False)
QWEN25_YARN = {"type": "yarn", "factor": 4.0,
               "original_max_position_embeddings": 32768}
DEEPSEEK_YARN = {"rope_type": "yarn", "factor": 40.0, "mscale": 1.0,
                 "mscale_all_dim": 0.707, "beta_fast": 32, "beta_slow": 1,
                 "original_max_position_embeddings": 4096}


@pytest.fixture
def jax_pallas(monkeypatch):
    """vptq_tpu's int8 / int4 path as on a TPU: Pallas in interpret mode
    and its numpy encoders."""
    monkeypatch.setattr(native, "_lib", lambda: None)
    monkeypatch.setattr(sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL",
                        "pallas")
    monkeypatch.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
    yield
    # jit caches are keyed on shapes, not on the switch: a trace made
    # here would serve a later test at the same shapes on the XLA path
    jax.clear_caches()


def _phi3(path, seed=71):
    jsc.write_synthetic_checkpoint(path, jsc.tiny_model_config(**PHI3),
                                   vq_kwargs=VQ, seed=seed)
    return str(path)


def _logits(jmodel, tmodel, tokens, max_seq=16):
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
    return got.numpy(), np.asarray(want, np.float32)


def _int4_logits_on_jax_inputs(jmodel, tmodel, tokens):
    """The logits of both packages with every int4 linear of the port fed
    the input JAX's linear got at the same call.

    The int4 kernels round x to bf16. The f32 sums before them (attention,
    the norms) differ in their last bits between the packages, and an x
    element that lies within such a difference of a bf16 rounding tie
    rounds to the other neighbour in one of them: one bf16 ulp, which the
    next layers carry to ~1e-2 of the logits' max. Here each port linear's
    own input is first held to JAX's at f32 rounding (1e-5 of max), and is
    then replaced by JAX's, so that no tie can part them."""
    seen = []

    def record(self, x):
        seen.append(np.array(x))
        return jcall(self, x)

    def replay(self, x):
        want = seen.pop(0).reshape(x.shape)
        np.testing.assert_allclose(x.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        return tcall(self, torch.from_numpy(want))

    jcall, tcall = jrt.Int4Linear.__call__, trt.Int4Linear.forward
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrt.Int4Linear, "__call__", record)
        mp.setattr(trt.Int4Linear, "forward", replay)
        got, want = _logits(jmodel, tmodel, tokens)
    assert not seen
    return got, want


def _tokens(jmodel, tmodel, prompt, max_seq=64, buckets=(16, 32), new=10,
            jdtype=jnp.float32, tdtype=torch.float32):
    want = JGenerator(jmodel, max_seq=max_seq, dtype=jdtype,
                      prompt_buckets=buckets).generate(prompt,
                                                       max_new_tokens=new)
    got = Generator(tmodel, max_seq=max_seq, dtype=tdtype,
                    prompt_buckets=buckets).generate(prompt,
                                                     max_new_tokens=new)
    return got, want


@pytest.mark.parametrize("fmt", ["int8", "int4", "bf16"])
def test_phi3_fused_checkpoint_matches_jax(tmp_path, jax_pallas, fmt):
    path = _phi3(tmp_path)
    jmodel = j_load_model(path, dtype=jnp.float32, runtime_format=fmt)
    tmodel = load_model(path, dtype=torch.float32, runtime_format=fmt,
                        device="cpu")
    attn, mlp = tmodel.blocks[0].attn, tmodel.blocks[0].mlp
    assert attn.q_proj is None and mlp.gate_proj is None
    assert attn.qkv_proj.out_features == 3 * 4 * 16
    assert mlp.gate_up_proj.out_features == 2 * TINY["intermediate_size"]
    x = np.random.default_rng(0).standard_normal((1, 6, TINY["hidden_size"]))
    x = x.astype(np.float32)
    jblock = jmodel.blocks[0]
    for j, t in ((jblock.attn.qkv_proj, attn.qkv_proj),
                 (jblock.mlp.gate_up_proj, mlp.gate_up_proj)):
        with torch.inference_mode():
            got = t(torch.from_numpy(x)).numpy()
        want = np.asarray(j(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    tokens = np.random.default_rng(12).integers(0, TINY["vocab_size"], (1, 6))
    got, want = _logits(jmodel, tmodel, tokens)
    tol = 1e-2 if fmt == "int4" else 1e-4
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())
    if fmt == "int4":
        # given JAX's input at every int4 linear, the logits meet 1e-4 too
        got, want = _int4_logits_on_jax_inputs(jmodel, tmodel, tokens)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    prompt = np.random.default_rng(3).integers(0, TINY["vocab_size"], 20)
    got, want = _tokens(jmodel, tmodel, prompt)
    assert len(want) == 10 and got == want


def test_phi3_port_writer_matches_and_loads_alike(tmp_path):
    """The port's writer emits vptq_tpu's fused tensors for one seed; its
    checkpoint gives the JAX logits."""
    _phi3(tmp_path / "jax", seed=5)
    tsc.write_synthetic_checkpoint(tmp_path / "port",
                                   tsc.tiny_model_config(**PHI3),
                                   vq_kwargs=VQ, seed=5)
    want = safetensors.numpy.load_file(tmp_path / "jax" / "model.safetensors")
    got = safetensors.numpy.load_file(tmp_path / "port" / "model.safetensors")
    assert sorted(got) == sorted(want)
    assert any(".qkv_proj." in k for k in got)
    assert any(".gate_up_proj." in k for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(tmp_path / "port" / "config.json") as f:
        assert json.load(f)["architectures"] == ["Phi3ForCausalLM"]
    path = str(tmp_path / "port")
    jmodel = j_load_model(path, dtype=jnp.float32, runtime_format="bf16")
    tmodel = load_model(path, dtype=torch.float32, runtime_format="bf16",
                        device="cpu")
    tokens = np.random.default_rng(2).integers(0, TINY["vocab_size"], (1, 9))
    got, want = _logits(jmodel, tmodel, tokens)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_phi3_window_is_parsed_as_jax_parses_it():
    d = dict(vocab_size=32064, hidden_size=3072, intermediate_size=8192,
             num_hidden_layers=32, num_attention_heads=32,
             num_key_value_heads=32, model_type="phi3", sliding_window=2047)
    assert tl.ModelConfig.from_hf_dict(d).sliding_window == 2047
    assert jl.ModelConfig.from_hf_dict(d).sliding_window == 2047
    off = dict(d, use_sliding_window=False)
    assert tl.ModelConfig.from_hf_dict(off).sliding_window is None
    assert jl.ModelConfig.from_hf_dict(off).sliding_window is None


# ----------------------------------------------------------------- yarn


@pytest.mark.parametrize("scaling,theta,dim", [
    (QWEN25_YARN, 1e6, 128),
    (QWEN25_YARN, 10000.0, 16),
    (DEEPSEEK_YARN, 10000.0, 64),
    (dict(DEEPSEEK_YARN, attention_factor=1.25), 10000.0, 64),
])
def test_yarn_frequencies_match_jax(scaling, theta, dim):
    kw = dict(TINY, head_dim=dim, rope_theta=theta,
              max_position_embeddings=131072,
              rope_scaling=tuple(sorted(scaling.items())))
    want, want_scale = jl.rope_frequencies(jl.ModelConfig(**kw))
    got, got_scale = tl.rope_frequencies(tl.ModelConfig(**kw), "cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert got_scale == want_scale > 1.0
    plain, _ = tl.rope_frequencies(tl.ModelConfig(**dict(kw, rope_scaling=None)),
                                   "cpu")
    assert not torch.equal(got, plain)


def test_qwen2_with_yarn_gives_jax_tokens(tmp_path):
    tsc.write_synthetic_checkpoint(
        tmp_path,
        tsc.tiny_model_config(**TINY, model_type="qwen2",
                              tie_word_embeddings=False,
                              rope_scaling=tuple(QWEN25_YARN.items())),
        vq_kwargs=VQ, seed=6, qkv_bias=True,
    )
    jmodel = j_load_model(str(tmp_path), dtype=jnp.float32,
                          runtime_format="bf16")
    tmodel = load_model(str(tmp_path), dtype=torch.float32,
                        runtime_format="bf16", device="cpu")
    assert tmodel.rope_scale == pytest.approx(0.1 * np.log(4.0) + 1.0)
    prompt = np.random.default_rng(8).integers(0, TINY["vocab_size"], 40)
    got, want = _tokens(jmodel, tmodel, prompt)
    assert len(want) == 10 and got == want


@pytest.mark.parametrize("kind", ["longrope", "dynamic"])
def test_other_rope_types_are_refused(kind):
    cfg = tl.ModelConfig(**TINY, rope_scaling=(("rope_type", kind),
                                                ("factor", 2.0)))
    with pytest.raises(NotImplementedError, match=kind):
        tl.rope_frequencies(cfg, "cpu")


def test_phimoe_is_refused(tmp_path):
    cfg = dict(TINY, model_type="phimoe", num_local_experts=4,
               num_experts_per_tok=2)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(cfg, f)
    with pytest.raises(NotImplementedError, match="phimoe"):
        load_model(str(tmp_path), device="cpu")


# ----------------------------------------------------------------- .bin


@pytest.mark.parametrize("shards", [1, 3])
def test_bin_checkpoint_reads_as_safetensors(tmp_path, shards):
    cfg = tsc.tiny_model_config(**PHI3)
    tsc.write_synthetic_checkpoint(tmp_path / "st", cfg, vq_kwargs=VQ, seed=7)
    tsc.write_synthetic_checkpoint(tmp_path / "bin", cfg, vq_kwargs=VQ,
                                   seed=7, bin_shards=shards)
    files = sorted(p.name for p in (tmp_path / "bin").iterdir())
    if shards == 1:
        assert files == ["config.json", "pytorch_model.bin"]
    else:
        assert "pytorch_model.bin.index.json" in files
        assert sum(f.endswith(".bin") for f in files) == shards
    want = load_state_dict(str(tmp_path / "st"))
    got = load_state_dict(str(tmp_path / "bin"))
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    prompt = np.random.default_rng(4).integers(0, TINY["vocab_size"], 12)
    outs = []
    for sub in ("st", "bin"):
        model = load_model(str(tmp_path / sub), dtype=torch.float32,
                           runtime_format="int8", device="cpu")
        outs.append(Generator(model, max_seq=64, dtype=torch.float32,
                              prompt_buckets=(16,)).generate(
                                  prompt, max_new_tokens=6))
    assert outs[0] == outs[1] and len(outs[0]) == 6
    jmodel = j_load_model(str(tmp_path / "bin"), dtype=jnp.float32,
                          runtime_format="bf16")
    assert jmodel.blocks[0].attn.qkv_proj is not None


def test_bin_reader_keeps_bf16_and_names_an_empty_directory(tmp_path):
    t = torch.randn(4, 3).to(torch.bfloat16)
    torch.save({"w": t}, tmp_path / "pytorch_model.bin")
    got = load_state_dict(str(tmp_path))["w"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, t)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match=str(empty)):
        load_state_dict(str(empty))


# ---------------------------------------------------------- flash switch


@pytest.fixture
def routes(monkeypatch):
    """Sequence lengths of the chunks that entered K8 and the cache
    attention."""
    calls = {"flash": [], "cache": []}
    cache_and_attend = tl._cache_and_attend

    def flash(q, k, v, scale):
        calls["flash"].append(q.shape[1])
        return flash_attention(q, k, v, scale)

    def cached(block_idx, q, *args, **kw):
        calls["cache"].append(q.shape[1])
        return cache_and_attend(block_idx, q, *args, **kw)

    monkeypatch.setattr(tl, "flash_attention", flash)
    monkeypatch.setattr(tl, "_cache_and_attend", cached)
    return calls


@pytest.mark.parametrize("switch", ["0", "1"])
def test_flash_switch_routes_a_long_bf16_chunk(tmp_path, monkeypatch, routes,
                                               switch):
    """An 1100-token prompt in bf16 at head size 64: its fresh 2048-token
    chunk goes to K8 once a layer, or with ``VPTQ_TPU_FLASH=0`` to the
    cache attention (K8 never called, its launch count untouched), and the
    tokens are JAX's either way."""
    monkeypatch.setenv("VPTQ_TPU_FLASH", switch)
    tsc.write_synthetic_checkpoint(
        tmp_path, tsc.tiny_model_config(**dict(TINY, head_dim=64),
                                        tie_word_embeddings=False),
        vq_kwargs=VQ, seed=5,
    )
    jmodel = j_load_model(str(tmp_path), dtype=jnp.bfloat16,
                          runtime_format="bf16")
    tmodel = load_model(str(tmp_path), dtype=torch.bfloat16,
                        runtime_format="bf16", device="cpu")
    cfg = tmodel.cfg
    assert tl.takes_flash(cfg, 2048, torch.bfloat16) is (switch == "1")
    launches = flash_attention.launches
    prompt = np.random.default_rng(1100).integers(0, TINY["vocab_size"], 1100)
    got, want = _tokens(jmodel, tmodel, prompt, max_seq=2048,
                        buckets=(128, 512, 2048), new=6,
                        jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    layers = cfg.num_hidden_layers
    if switch == "0":
        assert routes["flash"] == []
        assert routes["cache"][:layers] == [2048] * layers
    else:
        assert routes["flash"] == [2048] * layers
    assert flash_attention.launches == launches
    assert len(want) == 6 and got == want
