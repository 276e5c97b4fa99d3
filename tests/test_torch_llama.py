"""vptq_tpu_torch decoder against vptq_tpu: logits for a prefill and 8
decode steps on a tiny GQA Llama, with and without llama3 RoPE scaling,
on the 256-block decode path (max_seq 256) and the plain one (64).

Both run f32 activations on the same bf16 dense weights, carried across
with ``convert.py``; only summation order and transcendental rounding
differ, so logits agree to 1e-4 of their largest magnitude.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import LLAMA3_SCALING, TINY, VQ, jax_params

from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.models.llama import forward as j_forward
from vptq_tpu.models.llama import init_cache as j_init_cache
from vptq_tpu.utils.synth_checkpoint import tiny_model_config, write_synthetic_checkpoint
from vptq_tpu_torch.convert import convert_params
from vptq_tpu_torch.models import llama as tl

TOL = 1e-4


def _models(path, llama3: bool, tied: bool):
    write_synthetic_checkpoint(
        path, tiny_model_config(**TINY, tie_word_embeddings=tied),
        vq_kwargs=VQ, seed=4,
    )
    jmodel = j_load_model(str(path), dtype=jnp.float32, runtime_format="bf16")
    with open(path / "config.json") as f:
        hf = json.load(f)
    if llama3:
        hf["rope_scaling"] = LLAMA3_SCALING
        jmodel = jmodel.replace(cfg=dataclasses.replace(
            jmodel.cfg, rope_scaling=tuple(sorted(LLAMA3_SCALING.items()))
        ))
    return jmodel, convert_params(jax_params(jmodel), hf, device="cpu")


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max()
    )


@pytest.mark.parametrize("max_seq", [256, 64])
@pytest.mark.parametrize("llama3", [False, True])
def test_forward_matches_vptq_tpu(tmp_path, llama3, max_seq):
    jmodel, tmodel = _models(tmp_path, llama3, tied=not llama3)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, TINY["vocab_size"], size=(2, 10))

    jcache = j_init_cache(jmodel.cfg, 2, max_seq, jnp.float32)
    tcache = tl.init_cache(tmodel.cfg, 2, max_seq, torch.float32, "cpu")
    jl, jcache = j_forward(
        jmodel, jnp.asarray(tokens, jnp.int32), jcache, dtype=jnp.float32,
        fresh_prefill=True,
    )
    with torch.inference_mode():
        tlog, tcache = tl.forward(
            tmodel, torch.from_numpy(tokens), tcache, dtype=torch.float32,
            fresh_prefill=True,
        )
    _close(tlog, jl)
    for _ in range(8):
        nxt = np.array(jnp.argmax(jl[:, -1], axis=-1))[:, None]
        jl, jcache = j_forward(
            jmodel, jnp.asarray(nxt, jnp.int32), jcache, dtype=jnp.float32
        )
        with torch.inference_mode():
            tlog, tcache = tl.forward(
                tmodel, torch.from_numpy(nxt), tcache, dtype=torch.float32
            )
        _close(tlog, jl)
    assert tcache.lengths.tolist() == [18, 18] and tcache.max_len == 18
    np.testing.assert_array_equal(
        np.asarray(jcache.lengths), tcache.lengths.numpy())


def test_rope_frequencies_match():
    from vptq_tpu.models.llama import ModelConfig as JConfig
    from vptq_tpu.models.llama import rope_frequencies as j_rope

    for scaling in (None, LLAMA3_SCALING):
        hf = dict(TINY, rope_theta=500000.0, rope_scaling=scaling)
        want, _ = j_rope(JConfig.from_hf_dict(hf))
        got, scale = tl.rope_frequencies(
            tl.ModelConfig.from_hf_dict(hf), "cpu"
        )
        assert scale == 1.0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_loader_refuses_unported_families(tmp_path):
    # Phi-3's fused layout loads since it is ported; Phi-3.5-MoE does not
    write_synthetic_checkpoint(
        tmp_path, tiny_model_config(**TINY, model_type="phimoe"),
        vq_kwargs=VQ, seed=1,
    )
    from vptq_tpu_torch.models.loader import load_model

    with pytest.raises(NotImplementedError, match="phimoe"):
        load_model(str(tmp_path), device="cpu")
