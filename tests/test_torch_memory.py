"""vptq_tpu_torch's ``utils/memory.py`` and the loader's budget check
against vptq_tpu's: every estimate is vptq_tpu's integer, and the bytes of
the model the port loads; the budget table, its text and the refusal are
vptq_tpu's; the loader refuses before it reads a weight."""

import json

import numpy as np
import pytest
import torch
from torch_port import TINY, VQ

import jax.numpy as jnp

from vptq_tpu.config import QuantizationConfig as JQuantizationConfig
from vptq_tpu.models.llama import ModelConfig as JModelConfig
from vptq_tpu.models.loader import load_model as j_load_model
from vptq_tpu.tools.plan import GEOMETRIES as J_GEOMETRIES
from vptq_tpu.utils import memory as jm
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu_torch import AutoModelForCausalLM
from vptq_tpu_torch.config import QuantizationConfig
from vptq_tpu_torch.models import loader
from vptq_tpu_torch.models.llama import ModelConfig
from vptq_tpu_torch.serving.generate import Generator
from vptq_tpu_torch.utils import memory as tm

FORMATS = ("int8", "int4", "int3", "int3-mixed", "int2", "int2-mixed",
           "bf16", "codebook")
COMMUNITY_VQ = (8, 65536, 256)
# tests/test_torch_moe.py's and tests/test_torch_deepseek.py's geometries
TINY_FAMILIES = {
    "llama": dict(TINY, tie_word_embeddings=False),
    "llama-tied": dict(TINY),
    "mixtral": dict(TINY, model_type="mixtral", num_local_experts=4,
                    num_experts_per_tok=2, tie_word_embeddings=False),
    "deepseek": dict(
        model_type="deepseek_v3", vocab_size=256, hidden_size=64,
        intermediate_size=96, num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=4, head_dim=16, q_lora_rank=24, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=2,
        n_shared_experts=1, n_group=4, topk_group=2,
        first_k_dense_replace=1, tie_word_embeddings=False,
    ),
}


def _configs(geometry: dict):
    """The same geometry as vptq_tpu's and as the port's ModelConfig."""
    kw = {**dict(tie_word_embeddings=False, model_type="llama"), **geometry}
    return JModelConfig(**kw), ModelConfig(**kw)


def _quant_all(in_out):
    """vptq_tpu's test_memory.py quantization config: every tail name at
    the community v8-k65536-256 geometry."""
    shared = {
        name: dict(
            in_features=i, out_features=o, vector_lens=[-1, 8],
            num_centroids=[-1, 65536], num_res_centroids=[-1, 256],
            group_num=1, group_size=i, outlier_size=0, is_indice_packed=True,
        )
        for name, (i, o) in in_out.items()
    }
    d = {"quant_method": "vptq", "shared_layer_config": shared}
    return JQuantizationConfig.from_dict(d), QuantizationConfig.from_dict(d)


def _checkpoint(tmp_path, family):
    jsc.write_synthetic_checkpoint(
        tmp_path, jsc.tiny_model_config(**TINY_FAMILIES[family]),
        vq_kwargs=VQ, seed=13,
    )
    with open(tmp_path / "config.json") as f:
        hf = json.load(f)
    return (JModelConfig.from_hf_dict(hf), ModelConfig.from_hf_dict(hf),
            JQuantizationConfig.from_dict(hf["quantization_config"]),
            QuantizationConfig.from_dict(hf["quantization_config"]))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("geometry", sorted(J_GEOMETRIES))
def test_planning_estimates_are_jax_integers(geometry, fmt):
    """Planning mode (no checkpoint): vptq_tpu's breakdown, integer for
    integer, on one device and in the blocked layouts of 2 and 8 shards,
    with and without the int8 lm_head."""
    jcfg, tcfg = _configs(J_GEOMETRIES[geometry])
    for shards in (1, 2, 8):
        for lm in (False, True):
            kw = dict(quantize_lm_head=lm, tp_shards=shards,
                      default_vq=COMMUNITY_VQ)
            assert (tm.estimate_model_bytes(tcfg, fmt, **kw)
                    == jm.estimate_model_bytes(jcfg, fmt, **kw))
    assert tm.kv_cache_bytes(tcfg, 3, 4096) == jm.kv_cache_bytes(
        jcfg, 3, 4096)


@pytest.mark.parametrize("fmt", FORMATS)
def test_checkpoint_estimates_are_jax_integers(fmt):
    """With a quantization config (vptq_tpu's Llama-2-70B one), each
    geometry row looked up by its tail name."""
    h, inter = 8192, 28672
    jq, tq = _quant_all({
        "q_proj": (h, 8192), "k_proj": (h, 1024), "v_proj": (h, 1024),
        "o_proj": (8192, h), "gate_proj": (h, inter), "up_proj": (h, inter),
        "down_proj": (inter, h),
    })
    jcfg, tcfg = _configs(J_GEOMETRIES["llama2-70b"])
    for shards in (1, 4):
        assert (tm.estimate_model_bytes(tcfg, fmt, tq, tp_shards=shards)
                == jm.estimate_model_bytes(jcfg, fmt, jq, tp_shards=shards))


@pytest.mark.parametrize("row_shards", [1, 2, 3, 8])
@pytest.mark.parametrize("fmt", FORMATS[:-1])
def test_linear_bytes_are_jax_integers(fmt, row_shards):
    """Odd widths too: the per-shard padding and the mixed formats' side
    matrices with their 128-column floor (under 128 columns every column)."""
    for out_f, in_f in ((4096, 4096), (576, 2048), (6144, 14336),
                        (200, 100), (96, 1000), (7, 4097)):
        assert (tm.linear_runtime_bytes(out_f, in_f, fmt, None, row_shards)
                == jm.linear_runtime_bytes(out_f, in_f, fmt, None,
                                           row_shards))


def _left_out(model) -> int:
    """The loaded bytes vptq_tpu's geometry leaves out of its estimate:
    Mixtral's bf16 router; DeepSeek's f32 router, correction bias and the
    latent norms (q_a, kv_a)."""
    n = 0
    for block in model.blocks:
        mlp, attn = block.mlp, block.attn
        if hasattr(mlp, "router"):
            n += mlp.router.weight.numel() * mlp.router.weight.element_size()
        for name in ("router_weight", "correction_bias"):
            if hasattr(mlp, name):
                n += getattr(mlp, name).numel() * 4
        for name in ("q_a_norm", "kv_a_norm"):
            t = getattr(attn, name, None)
            if t is not None:
                n += t.numel() * 4
    return n


@pytest.mark.parametrize("fmt,fuse", [
    ("int8", True), ("int8", False), ("int4", True), ("int3", True),
    ("int2", True), ("bf16", True), ("codebook", False),
])
@pytest.mark.parametrize("family", sorted(TINY_FAMILIES))
def test_estimates_equal_the_loaded_bytes(tmp_path, family, fmt, fuse):
    """The port's loaded model (bf16, CPU) holds exactly the estimate's
    bytes (dense Llama, tied or not), plus what vptq_tpu's geometry leaves
    out of MoE and MLA blocks; the estimate is vptq_tpu's integer."""
    jcfg, tcfg, jq, tq = _checkpoint(tmp_path, family)
    est = tm.estimate_model_bytes(tcfg, fmt, tq)
    assert est == jm.estimate_model_bytes(jcfg, fmt, jq)
    model = loader.load_model(str(tmp_path), runtime_format=fmt, fuse=fuse,
                              device="cpu")
    assert tm.model_bytes(model) == est["total"] + _left_out(model)
    if family.startswith("llama"):
        assert _left_out(model) == 0


def test_model_bytes_counts_a_storage_once():
    """Buffers that view one storage (stacked experts, a tied head) count
    once; non-persistent buffers (rope frequencies, expert ids) not."""
    m = torch.nn.Module()
    base = torch.zeros(10, dtype=torch.float32)
    m.register_buffer("a", base[:6])
    m.register_buffer("b", base[4:])  # overlaps a by 2 elements
    m.register_buffer("c", base[:6])
    m.register_buffer("d", torch.zeros(3, dtype=torch.int8))
    m.register_buffer("e", torch.zeros(5), persistent=False)
    m.register_buffer("f", None)
    assert tm.model_bytes(m) == 4 * 10 + 3
    m.register_buffer("g", torch.empty(7, device="meta"))
    assert tm.model_bytes(m) == 4 * 10 + 3 + 4 * 7


def test_kv_cache_bytes_are_the_generators(tmp_path):
    """The Generator's persistent cache (one sequence at ``max_seq``) is
    ``kv_cache_bytes``; MLA's one latent head too."""
    for family in ("llama", "deepseek"):
        path = tmp_path / family
        _jcfg, tcfg, _jq, _tq = _checkpoint(path, family)
        model = loader.load_model(str(path), runtime_format="int8",
                                  device="cpu")
        gen = Generator(model, max_seq=64)
        got = sum(t.numel() * t.element_size()
                  for t in (*gen.cache.k, *gen.cache.v))
        assert got == tm.kv_cache_bytes(tcfg, 1, 64)


def test_budget_table_text_and_refusal_are_jax(tmp_path):
    """The rows, their text and the refusal's message are vptq_tpu's."""
    jcfg, tcfg = _configs(J_GEOMETRIES["llama3-8b"])
    for hbm_bytes in (16 * 2 ** 30, 80 * 10 ** 9):
        kw = dict(hbm_bytes=hbm_bytes, max_seq=4096, batch=2,
                  default_vq=COMMUNITY_VQ,
                  formats=("codebook", "int2", "int2-mixed", "int3",
                           "int4", "int8", "bf16"))
        want = jm.budget_table(jcfg, **kw)
        got = tm.budget_table(tcfg, **kw)
        assert got == want
        assert tm.format_budget_table(got) == jm.format_budget_table(want)
    for args in ((40 * 2 ** 30, 1, 16 * 2 ** 30, 0.9, "model"),
                 (90e9, 1, 80e9, 0.8, "int8 model (9.00 GiB weights)")):
        with pytest.raises(jm.HBMBudgetError) as want:
            jm.check_budget(*args)
        with pytest.raises(tm.HBMBudgetError) as got:
            tm.check_budget(*args)
        assert str(got.value) == str(want.value)
    tm.check_budget(40 * 2 ** 30, 4, 16 * 2 ** 30)


def test_budget_table_needs_a_card_or_a_size(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _jcfg, tcfg = _configs(J_GEOMETRIES["llama3-8b"])
    assert tm.detect_hbm_bytes() is None
    assert tm.detect_hbm_bytes("cpu") is None
    with pytest.raises(ValueError, match="hbm_bytes"):
        tm.budget_table(tcfg)


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int2-mixed"])
def test_loader_refuses_before_reading_a_weight(tmp_path, monkeypatch, fmt):
    """``load_model(hbm_gb=...)``, ``from_pretrained`` and a calibrated load
    raise vptq_tpu's HBMBudgetError, with its message, before the reader
    is called."""
    jsc.write_synthetic_checkpoint(
        tmp_path, jsc.tiny_model_config(**TINY_FAMILIES["llama"]),
        vq_kwargs=VQ, seed=2,
    )
    with pytest.raises(jm.HBMBudgetError) as want:
        j_load_model(str(tmp_path), runtime_format=fmt, hbm_gb=0.0004,
                     dtype=jnp.float32)

    def reader(*_a, **_k):
        raise AssertionError("the reader was called")

    monkeypatch.setattr(loader, "load_state_dict", reader)
    with pytest.raises(tm.HBMBudgetError) as got:
        loader.load_model(str(tmp_path), runtime_format=fmt, hbm_gb=0.0004,
                          device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(tm.HBMBudgetError):
        AutoModelForCausalLM.from_pretrained(
            str(tmp_path), runtime_format=fmt, hbm_gb=0.0004, device="cpu")
    with pytest.raises(tm.HBMBudgetError):
        loader.load_model(str(tmp_path), runtime_format=fmt, hbm_gb=0.002,
                          hbm_utilization=0.2, device="cpu")


def test_loader_loads_within_its_budget(tmp_path):
    """Within the budget, or on the CPU without one (no card to read), the
    load goes on."""
    jsc.write_synthetic_checkpoint(
        tmp_path, jsc.tiny_model_config(**TINY_FAMILIES["llama"]),
        vq_kwargs=VQ, seed=2,
    )
    model = loader.load_model(str(tmp_path), runtime_format="int8",
                              hbm_gb=16.0, device="cpu")
    engine = AutoModelForCausalLM.from_pretrained(
        str(tmp_path), runtime_format="int8", device="cpu",
        dtype=torch.float32, hbm_gb=1.0, max_seq=32)
    assert len(engine.generate([1, 2, 3], max_new_tokens=2)) == 2
    for a, b in zip(model.state_dict().values(),
                    loader.load_model(str(tmp_path), runtime_format="int8",
                                      device="cpu").state_dict().values()):
        assert torch.equal(a, b)


def test_inverse_permutation_is_int32_as_jax_holds_it(tmp_path):
    """The codebook layer's inverse permutation is int32 (vptq_tpu's, and
    what ``_codebook_bytes`` counts), with vptq_tpu's values."""
    jsc.write_synthetic_checkpoint(
        tmp_path, jsc.tiny_model_config(**TINY_FAMILIES["llama"]),
        vq_kwargs=VQ, seed=2,
    )
    got = loader.load_model(str(tmp_path), runtime_format="codebook",
                            device="cpu").blocks[0].attn.q_proj.inv_perm
    want = j_load_model(str(tmp_path), runtime_format="codebook"
                        ).blocks[0].attn.q_proj.inv_perm
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
