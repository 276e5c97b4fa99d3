"""vptq_tpu_torch end to end in the int4, int3 and int2 formats.

* A checkpoint from vptq_tpu's writer, loaded by both packages in each
  format, gives identical greedy tokens from ``Generator.generate``. The
  JAX side runs its Pallas kernels in interpret mode (its non-Pallas path
  does not round activations to bf16, as K2–K4 do) and its numpy
  encoders.
* ``convert.py`` carries the JAX model across into the right layer
  classes, with the same logits as the port's own loader.
* The calibrated formats refuse to load.
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import TINY, VQ, jax_params

from vptq_tpu import native
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.models.llama import forward as j_forward
from vptq_tpu.models.llama import init_cache as j_init_cache
from vptq_tpu.serving.generate import Generator as JGenerator
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu_torch.convert import _packed_kind, convert_params
from vptq_tpu_torch.layers.runtime import Int2Linear, Int3Linear, Int4Linear
from vptq_tpu_torch.models import llama as tl
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.ops.w2_matmul import w2_matmul
from vptq_tpu_torch.ops.w3_matmul import w3_matmul
from vptq_tpu_torch.ops.w4_matmul import w4_matmul
from vptq_tpu_torch.serving.generate import Generator

FORMATS = {
    "int4": (Int4Linear, w4_matmul),
    "int3": (Int3Linear, w3_matmul),
    "int2": (Int2Linear, w2_matmul),
}


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(native, "_lib", lambda: None)
    monkeypatch.setattr(
        sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL", "pallas"
    )
    monkeypatch.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")


def _checkpoint(path, seed):
    jsc.write_synthetic_checkpoint(
        path, jsc.tiny_model_config(**TINY, tie_word_embeddings=False),
        vq_kwargs=VQ, seed=seed,
    )
    return str(path)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_greedy_tokens_identical(tmp_path, jax_pallas, fmt):
    path = _checkpoint(tmp_path, seed=4)
    prompt = np.random.default_rng(3).integers(0, TINY["vocab_size"], 20)
    buckets = (16, 32)

    jmodel = j_load_model(path, dtype=jnp.float32, runtime_format=fmt)
    want = JGenerator(
        jmodel, max_seq=64, dtype=jnp.float32, prompt_buckets=buckets
    ).generate(prompt, max_new_tokens=10, chunk_size=4)

    cls, kernel = FORMATS[fmt]
    before = kernel.launches
    tmodel = load_model(
        path, dtype=torch.float32, runtime_format=fmt, device="cpu"
    )
    assert isinstance(tmodel.blocks[0].mlp.gate_up_proj, cls)
    got = Generator(
        tmodel, max_seq=64, dtype=torch.float32, prompt_buckets=buckets
    ).generate(prompt, max_new_tokens=10, chunk_size=4)
    assert kernel.launches == before  # the CPU runs the plain version
    assert len(want) == 10
    assert got == want


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_convert_and_loader_give_same_logits(tmp_path, jax_pallas, fmt):
    path = _checkpoint(tmp_path, seed=5)
    jmodel = j_load_model(path, dtype=jnp.float32, runtime_format=fmt)
    with open(tmp_path / "config.json") as f:
        hf = json.load(f)
    converted = convert_params(jax_params(jmodel), hf, device="cpu")
    cls = FORMATS[fmt][0]
    block = converted.blocks[0]
    for layer in (block.attn.qkv_proj, block.attn.o_proj,
                  block.mlp.gate_up_proj, block.mlp.down_proj):
        assert type(layer) is cls
    loaded = load_model(
        path, dtype=torch.float32, runtime_format=fmt, device="cpu"
    )

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
    # the loader builds the very bytes convert carried across
    np.testing.assert_array_equal(outs[0], outs[1])
    want = np.asarray(want)
    np.testing.assert_allclose(
        outs[0], want, rtol=1e-4, atol=1e-4 * np.abs(want).max()
    )


def test_packed_kind_refuses_what_fits_no_format():
    import ml_dtypes

    wq = np.zeros((8, 512), np.int8)
    bf16 = ml_dtypes.bfloat16
    assert _packed_kind("p", wq, np.zeros((8, 8), bf16)) is Int4Linear
    assert _packed_kind("p", wq, np.zeros((8, 32), bf16)) is Int2Linear
    for scales in (np.zeros((8, 8), np.float16), np.zeros((3, 8), bf16),
                   np.zeros((8, 128), bf16)):
        with pytest.raises(ValueError, match="cannot tell"):
            _packed_kind("p", wq, scales)


@pytest.mark.parametrize("fmt", ["int4-mixed", "int3-mixed", "int2-mixed"])
def test_calibrated_formats_raise(tmp_path, fmt):
    path = _checkpoint(tmp_path, seed=1)
    with pytest.raises(NotImplementedError, match="calibration"):
        load_model(path, runtime_format=fmt, device="cpu")
