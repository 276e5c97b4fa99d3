"""The Qwen2 and Mistral families, and K7's plain version, against vptq_tpu.

* Qwen2 style (a bias on q_proj, k_proj and v_proj): the port's writer
  emits the JAX writer's tensors; logits and greedy tokens agree in int8
  and bf16, fused and unfused; ``convert.py`` carries the bias of every
  leaf kind (int8, int4, int3, int2, dense, codebook).
* Mistral style (``sliding_window``): the window bites in the prefill
  (prompt 100 > window 32), in the 256-block decode path and in the plain
  decode path; logits and greedy tokens agree.
* ``bf16_matmul_reference`` against the Pallas ``bf16_matmul`` in
  interpret mode.

The JAX side runs its Pallas kernels in interpret mode and its numpy
encoders, as on a TPU.
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import torch
from torch_port import TINY, VQ, jax_params

from vptq_tpu import native
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.models.llama import forward as j_forward
from vptq_tpu.models.llama import init_cache as j_init_cache
from vptq_tpu.ops.pallas_gemm import bf16_matmul as j_bf16_matmul
from vptq_tpu.serving.generate import Generator as JGenerator
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu_torch.convert import convert_params
from vptq_tpu_torch.models import llama as tl
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.ops.bf16_matmul import bf16_matmul, bf16_matmul_reference
from vptq_tpu_torch.serving.generate import Generator
from vptq_tpu_torch.utils import synth_checkpoint as tsc

QWEN = dict(TINY, tie_word_embeddings=False, model_type="qwen2",
            rope_theta=1e6, rms_norm_eps=1e-6)
MISTRAL = dict(TINY, tie_word_embeddings=False, model_type="mistral",
               sliding_window=32)


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(native, "_lib", lambda: None)
    monkeypatch.setattr(
        sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL", "pallas"
    )
    monkeypatch.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")


def _write(path, cfg, seed, **kwargs):
    tsc.write_synthetic_checkpoint(
        path, tsc.tiny_model_config(**cfg), vq_kwargs=VQ, seed=seed, **kwargs
    )
    return str(path)


def _logits(jmodel, tmodel, tokens, max_seq):
    want, _ = j_forward(
        jmodel, jnp.asarray(tokens, jnp.int32),
        j_init_cache(jmodel.cfg, 1, max_seq, jnp.float32), dtype=jnp.float32,
        fresh_prefill=True,
    )
    with torch.inference_mode():
        got, _ = tl.forward(
            tmodel, torch.from_numpy(tokens),
            tl.init_cache(tmodel.cfg, 1, max_seq, torch.float32, "cpu"),
            dtype=torch.float32, fresh_prefill=True,
        )
    return got.numpy(), np.asarray(want)


def _assert_logits_close(got, want):
    # f32 activations on the same weights: summation order and
    # transcendental rounding only
    np.testing.assert_allclose(
        got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max()
    )


# ---------------------------------------------------------------- Qwen2


def test_writer_emits_same_tensors_with_qkv_bias(tmp_path):
    jsc.write_synthetic_checkpoint(
        tmp_path / "jax", jsc.tiny_model_config(**QWEN), vq_kwargs=VQ, seed=3,
        qkv_bias=True,
    )
    _write(tmp_path / "port", QWEN, 3, qkv_bias=True)
    want = safetensors.numpy.load_file(tmp_path / "jax" / "model.safetensors")
    got = safetensors.numpy.load_file(tmp_path / "port" / "model.safetensors")
    assert sorted(got) == sorted(want)
    biases = [n for n in want if n.endswith("_proj.bias")]
    assert len(biases) == 3 * TINY["num_hidden_layers"]
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)

    def config(side):
        with open(tmp_path / side / "config.json") as f:
            return json.load(f)

    jconf, tconf = config("jax"), config("port")
    assert tconf["attention_bias"] is True and tconf["model_type"] == "qwen2"
    assert {k: jconf[k] for k in tconf} == tconf


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("fmt", ["int8", "bf16"])
def test_qwen2_logits_and_greedy_tokens(tmp_path, jax_pallas, fmt, fuse):
    path = _write(tmp_path, QWEN, 7, qkv_bias=True)
    jmodel = j_load_model(
        path, dtype=jnp.float32, runtime_format=fmt, fuse=fuse
    )
    tmodel = load_model(
        path, dtype=torch.float32, runtime_format=fmt, fuse=fuse, device="cpu"
    )
    attn = tmodel.blocks[0].attn
    assert (attn.qkv_proj is not None) == fuse
    biased = attn.qkv_proj if fuse else attn.k_proj
    assert biased.bias is not None and float(biased.bias.abs().sum()) > 0
    assert attn.o_proj.bias is None

    rng = np.random.default_rng(2)
    tokens = rng.integers(0, TINY["vocab_size"], (1, 21))
    _assert_logits_close(*_logits(jmodel, tmodel, tokens, 64))

    prompt = rng.integers(0, TINY["vocab_size"], 20)
    buckets = (16, 32)
    want = JGenerator(
        jmodel, max_seq=64, dtype=jnp.float32, prompt_buckets=buckets
    ).generate(prompt, max_new_tokens=10, chunk_size=4)
    got = Generator(
        tmodel, max_seq=64, dtype=torch.float32, prompt_buckets=buckets
    ).generate(prompt, max_new_tokens=10, chunk_size=4)
    assert len(want) == 10 and got == want


@pytest.mark.parametrize(
    "fmt", ["int8", "int4", "int3", "int2", "bf16", "codebook"]
)
def test_convert_carries_the_qkv_bias(tmp_path, jax_pallas, fmt):
    """The JAX model's leaves, as numpy arrays, give the port's loader's
    own Qwen2 model: every leaf kind keeps its bias."""
    path = _write(tmp_path, QWEN, 8, qkv_bias=True)
    jmodel = j_load_model(path, dtype=jnp.float32, runtime_format=fmt)
    with open(tmp_path / "config.json") as f:
        hf = json.load(f)
    params = jax_params(jmodel)
    fused = fmt != "codebook"
    names = ["qkv_proj"] if fused else ["q_proj", "k_proj", "v_proj"]
    assert all(f"blocks.1.attn.{n}.bias" in params for n in names)
    converted = convert_params(params, hf, device="cpu")
    loaded = load_model(
        path, dtype=torch.float32, runtime_format=fmt, device="cpu"
    )
    for n in names:
        torch.testing.assert_close(
            getattr(converted.blocks[1].attn, n).bias,
            getattr(loaded.blocks[1].attn, n).bias, rtol=0, atol=0,
        )
    tokens = np.random.default_rng(0).integers(0, TINY["vocab_size"], (1, 9))
    got_c, want = _logits(jmodel, converted, tokens, 16)
    got_l, _ = _logits(jmodel, loaded, tokens, 16)
    # the loader builds the very bytes convert carried across
    np.testing.assert_array_equal(got_c, got_l)
    _assert_logits_close(got_c, want)
    # and the bias matters: without it the logits move
    for n in names:
        getattr(converted.blocks[1].attn, n).bias.zero_()
    moved, _ = _logits(jmodel, converted, tokens, 16)
    assert np.abs(moved - want).max() > 1e-3 * np.abs(want).max()


def test_real_qwen2_config_loads(tmp_path):
    """Qwen's own config.json has neither ``attention_bias`` nor
    ``head_dim``, and ``use_sliding_window`` false beside a window; the
    bias tensors travel with the checkpoint all the same."""
    path = _write(tmp_path, QWEN, 9, qkv_bias=True)
    with open(tmp_path / "config.json") as f:
        hf = json.load(f)
    del hf["attention_bias"], hf["head_dim"]
    hf.update(use_sliding_window=False, sliding_window=131072,
              max_window_layers=28)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(hf, f)
    model = load_model(path, dtype=torch.float32, runtime_format="int8",
                       device="cpu")
    assert model.cfg.sliding_window is None and not model.cfg.attention_bias
    assert model.blocks[0].attn.qkv_proj.bias is not None


# -------------------------------------------------------------- Mistral


@pytest.mark.parametrize("max_seq", [
    256,  # decode through _decode_attend_blocks
    160,  # decode through the plain masked attention
])
def test_mistral_window_in_prefill_and_decode(tmp_path, max_seq):
    path = _write(tmp_path, MISTRAL, 11)
    with open(tmp_path / "config.json") as f:
        hf = json.load(f)
    assert hf["sliding_window"] == 32
    assert hf["architectures"] == ["MistralForCausalLM"]
    jmodel = j_load_model(path, dtype=jnp.float32, runtime_format="bf16")
    tmodel = load_model(
        path, dtype=torch.float32, runtime_format="bf16", device="cpu"
    )
    assert jmodel.cfg.sliding_window == tmodel.cfg.sliding_window == 32

    rng = np.random.default_rng(4)
    tokens = rng.integers(0, TINY["vocab_size"], (1, 100))
    got, want = _logits(jmodel, tmodel, tokens, max_seq)
    _assert_logits_close(got, want)
    # the window bites: the same weights without it give other logits
    full = convert_params(
        jax_params(jmodel), dict(hf, sliding_window=None), device="cpu"
    )
    unwindowed, _ = _logits(jmodel, full, tokens, max_seq)
    assert np.abs(unwindowed[0, :32] - want[0, :32]).max() <= (
        1e-4 * np.abs(want).max()
    )
    assert np.abs(unwindowed[0, 40:] - want[0, 40:]).max() > (
        1e-2 * np.abs(want).max()
    )

    prompt = rng.integers(0, TINY["vocab_size"], 100)
    want_toks = JGenerator(jmodel, max_seq=max_seq, dtype=jnp.float32).generate(
        prompt, max_new_tokens=40, chunk_size=16
    )
    got_toks = Generator(tmodel, max_seq=max_seq, dtype=torch.float32).generate(
        prompt, max_new_tokens=40, chunk_size=16
    )
    full_toks = Generator(full, max_seq=max_seq, dtype=torch.float32).generate(
        prompt, max_new_tokens=40, chunk_size=16
    )
    assert len(want_toks) == 40 and got_toks == want_toks
    assert full_toks != got_toks


def test_mixtral_with_a_window_loads(tmp_path):
    """A sliding window no longer keeps a Mixtral checkpoint out."""
    cfg = dict(TINY, tie_word_embeddings=False, model_type="mixtral",
               num_local_experts=4, num_experts_per_tok=2, sliding_window=16)
    path = _write(tmp_path, cfg, 12)
    jmodel = j_load_model(path, dtype=jnp.float32, runtime_format="bf16")
    tmodel = load_model(
        path, dtype=torch.float32, runtime_format="bf16", device="cpu"
    )
    tokens = np.random.default_rng(5).integers(0, TINY["vocab_size"], (1, 40))
    _assert_logits_close(*_logits(jmodel, tmodel, tokens, 64))


def test_port_writer_refuses_other_dense_layouts(tmp_path):
    with pytest.raises(NotImplementedError, match="Qwen2"):
        tsc.write_synthetic_checkpoint(
            tmp_path, tsc.tiny_model_config(model_type="phi3")
        )


# ------------------------------------------------------------------- K7


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tokens", [1, 5, 130])
def test_bf16_matmul_reference_matches_pallas(monkeypatch, tokens, out_dtype):
    monkeypatch.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(tokens)
    out_f, in_f = 203, 1024  # an odd out: the last out-tile is ragged
    x = rng.standard_normal((tokens, in_f)).astype(np.float32)
    w = (0.05 * rng.standard_normal((out_f, in_f))).astype(np.float32)
    want = np.asarray(
        j_bf16_matmul(
            jnp.asarray(x), jnp.asarray(w).astype(jnp.bfloat16),
            out_dtype=getattr(jnp, out_dtype),
        ).astype(jnp.float32)
    )
    tw = torch.from_numpy(w).to(torch.bfloat16)
    before = bf16_matmul.launches
    got = bf16_matmul(
        torch.from_numpy(x), tw, out_dtype=getattr(torch, out_dtype)
    )
    assert bf16_matmul.launches == before  # the CPU runs the plain version
    assert got.dtype == getattr(torch, out_dtype)
    assert got.shape == (tokens, out_f)
    # exact bf16 products summed in f32: summation order only in f32; in
    # bf16 a sum on a rounding edge may land one ulp (2^-8) away
    tol = 1e-5 if out_dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(), want, rtol=tol,
        atol=tol * np.abs(want).max(),
    )


def test_bf16_matmul_shapes_and_refusals():
    w = torch.zeros((8, 1024), dtype=torch.bfloat16)
    x = torch.ones((2, 3, 1024))
    y = bf16_matmul(x, w)
    assert y.shape == (2, 3, 8) and y.dtype == torch.float32
    assert bf16_matmul_reference(x.to(torch.bfloat16), w).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="% 512"):
        bf16_matmul(torch.ones((2, 768)), torch.zeros((8, 768),
                                                      dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="bfloat16"):
        bf16_matmul(x, w.to(torch.float32))
    with pytest.raises(ValueError, match="last dim"):
        bf16_matmul(torch.ones((2, 512)), w)
    # the JAX entry refuses the same width
    with pytest.raises(ValueError, match="% 512"):
        j_bf16_matmul(jnp.ones((2, 768)), jnp.zeros((8, 768), jnp.bfloat16))
