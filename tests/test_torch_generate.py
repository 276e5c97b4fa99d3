"""vptq_tpu_torch end to end against vptq_tpu.

* A checkpoint from vptq_tpu's writer, loaded by both packages in the
  int8 format, gives identical greedy tokens from ``Generator.generate``.
  The JAX side runs the Pallas ``w8_matmul`` in interpret mode, which
  rounds activations to bf16 as K1 does.
* The port's writer emits the same tensors as vptq_tpu's for one seed.
* ``convert.py`` (from an int8 or a codebook model) and the port's
  loader give the same logits.
"""

import json
import sys

import jax
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
from vptq_tpu.serving.generate import Generator as JGenerator
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu_torch.convert import convert_params
from vptq_tpu_torch.models import llama as tl
from vptq_tpu_torch.models.loader import _read_safetensors, load_model
from vptq_tpu_torch.ops.w8_matmul import w8_matmul
from vptq_tpu_torch.serving.generate import Generator
from vptq_tpu_torch.utils import synth_checkpoint as tsc


@pytest.fixture
def jax_pallas_int8(monkeypatch):
    """vptq_tpu's int8 path as on a TPU: the Pallas kernel (interpret
    mode) and the numpy encoder (its C++ host library multiplies by
    1/scale where the numpy path divides)."""
    monkeypatch.setattr(native, "_lib", lambda: None)
    monkeypatch.setattr(
        sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL", "pallas"
    )
    monkeypatch.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
    yield
    # jit caches are keyed on shapes, not on the switch: a trace made
    # here would serve a later test at the same shapes on the XLA path
    jax.clear_caches()


def _checkpoint(path, seed=2):
    jsc.write_synthetic_checkpoint(
        path, jsc.tiny_model_config(**TINY, tie_word_embeddings=False),
        vq_kwargs=VQ, seed=seed,
    )
    return str(path)


@pytest.mark.parametrize(
    "max_seq",
    [
        44,   # prompt 36 = 32 + 4 padded to 16: pad rows run past max_seq
        256,  # the 256-block decode path
    ],
)
def test_greedy_tokens_identical(tmp_path, jax_pallas_int8, max_seq):
    path = _checkpoint(tmp_path)
    prompt = np.random.default_rng(1).integers(0, TINY["vocab_size"], 36)
    buckets = (16, 32)

    jmodel = j_load_model(path, dtype=jnp.float32, runtime_format="int8")
    want = JGenerator(
        jmodel, max_seq=max_seq, dtype=jnp.float32, prompt_buckets=buckets
    ).generate(prompt, max_new_tokens=12, chunk_size=5)

    before = w8_matmul.launches
    tmodel = load_model(path, dtype=torch.float32, runtime_format="int8", device="cpu")
    got = Generator(
        tmodel, max_seq=max_seq, dtype=torch.float32, prompt_buckets=buckets
    ).generate(prompt, max_new_tokens=12, chunk_size=5)
    assert w8_matmul.launches == before
    assert len(want) == min(12, max_seq - len(prompt))
    assert got == want


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_fp16_greedy_tokens_identical(tmp_path, jax_pallas_int8, fmt):
    """A model loaded in fp16 computes what vptq_tpu's fp16 model does:
    the linears round x to bf16, sum in f32 and round the sums to fp16."""
    path = _checkpoint(tmp_path, seed=4)
    prompt = np.random.default_rng(3).integers(0, TINY["vocab_size"], 20)
    buckets = (16, 32)
    jmodel = j_load_model(path, dtype=jnp.float16, runtime_format=fmt)
    want = JGenerator(
        jmodel, max_seq=64, dtype=jnp.float16, prompt_buckets=buckets
    ).generate(prompt, max_new_tokens=10, chunk_size=4)
    tmodel = load_model(path, dtype=torch.float16, runtime_format=fmt,
                        device="cpu")
    assert tmodel.embed_tokens.dtype == torch.float16
    got = Generator(
        tmodel, max_seq=64, dtype=torch.float16, prompt_buckets=buckets
    ).generate(prompt, max_new_tokens=10, chunk_size=4)
    assert len(want) == 10 and got == want


@pytest.mark.parametrize(
    "vq",
    [
        VQ,
        dict(vector_len=4, num_centroids=64, num_res_centroids=16,
             outlier_size=8, outlier_vector_len=4, num_outlier_centroids=16,
             enable_norm=True),
    ],
)
def test_writer_emits_same_tensors(tmp_path, vq):
    cfg = dict(TINY, tie_word_embeddings=False)
    jsc.write_synthetic_checkpoint(
        tmp_path / "jax", jsc.tiny_model_config(**cfg), vq_kwargs=vq, seed=3
    )
    tsc.write_synthetic_checkpoint(
        tmp_path / "port", tsc.tiny_model_config(**cfg), vq_kwargs=vq, seed=3
    )
    want = safetensors.numpy.load_file(tmp_path / "jax" / "model.safetensors")
    got = safetensors.numpy.load_file(tmp_path / "port" / "model.safetensors")
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    # the port's reader sees the JAX writer's file as safetensors does
    read = _read_safetensors(tmp_path / "jax" / "model.safetensors")
    for name, arr in want.items():
        np.testing.assert_array_equal(read[name].numpy(), arr, err_msg=name)

    def config(side):
        with open(tmp_path / side / "config.json") as f:
            return json.load(f)

    jconf, tconf = config("jax"), config("port")
    assert {k: jconf[k] for k in tconf} == tconf
    assert tconf["quantization_config"] == jconf["quantization_config"]


@pytest.mark.parametrize("fmt", ["int8", "codebook"])
def test_convert_and_loader_give_same_logits(tmp_path, jax_pallas_int8, fmt):
    path = _checkpoint(tmp_path, seed=6)
    jmodel = j_load_model(path, dtype=jnp.float32, runtime_format=fmt)
    with open(tmp_path / "config.json") as f:
        hf = json.load(f)
    converted = convert_params(jax_params(jmodel), hf, device="cpu")
    loaded = load_model(path, dtype=torch.float32, runtime_format=fmt, device="cpu")

    tokens = np.random.default_rng(0).integers(0, TINY["vocab_size"], (1, 7))
    want, _ = j_forward(
        jmodel, jnp.asarray(tokens, jnp.int32),
        j_init_cache(jmodel.cfg, 1, 16, jnp.float32), dtype=jnp.float32,
    )
    outs = []
    for model in (converted, loaded):
        with torch.inference_mode():
            logits, _ = tl.forward(
                model, torch.from_numpy(tokens),
                tl.init_cache(model.cfg, 1, 16, torch.float32, "cpu"),
                dtype=torch.float32,
            )
        outs.append(logits.numpy())
    # the loader builds the very weights convert carried across
    np.testing.assert_array_equal(outs[0], outs[1])
    want = np.asarray(want)
    np.testing.assert_allclose(
        outs[0], want, rtol=1e-4, atol=1e-4 * np.abs(want).max()
    )
