"""vptq_tpu_torch's runtime checkpoints and mixed layers against vptq_tpu.

* A runtime checkpoint that vptq_tpu writes (int8, int4, int3, int2,
  bf16, the calibrated int2-mixed, int3-mixed and int4-mixed at
  ``calibration=128``, and Mixtral's stacked int8 experts) loads in the
  port on the CPU with byte-equal tensors, logits within 1e-4 of the max
  |logit| of JAX's (its Pallas kernels in interpret mode) and the JAX
  ``Generator``'s greedy tokens.
* A runtime checkpoint that the port writes loads in vptq_tpu with
  byte-equal tensors and an equal config.
* ``Int2MixedLinear`` / ``Int3MixedLinear``, fused and not, and the
  ``*_from_q`` constructors against vptq_tpu's; ``convert_params`` on a
  calibrated JAX tree.
* DeepSeek (MLA's absorbed uk / uv and norms, the router weight and
  correction bias, stacked routed and fused shared experts) both ways.
* The reader refuses blocked (``shards > 1``) layers and another
  ``format_version``; the writer a codebook layer.
"""

import dataclasses
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import TINY, VQ, jax_params

from vptq_tpu import native
from vptq_tpu.layers import runtime as jrt
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.models.llama import ModelConfig as JModelConfig
from vptq_tpu.models.llama import forward as j_forward
from vptq_tpu.models.llama import init_cache as j_init_cache
from vptq_tpu.serving.generate import Generator as JGenerator
from vptq_tpu.tools import export_runtime as jexport
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu_torch.convert import convert_params
from vptq_tpu_torch.layers import runtime as trt
from vptq_tpu_torch.models import llama as tl
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.serving.generate import Generator
from vptq_tpu_torch.tools import export_runtime as texport
from vptq_tpu_torch.utils.synth import mixed_model

MIXTRAL = dict(model_type="mixtral", num_local_experts=4,
               num_experts_per_tok=2)
# a dense layer, then MLA over grouped routing with a shared expert
DEEPSEEK = dict(
    model_type="deepseek_v3", q_lora_rank=24, kv_lora_rank=16,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    rope_interleave=True, moe_intermediate_size=32, n_routed_experts=8,
    num_experts_per_tok=2, n_shared_experts=1, n_group=4, topk_group=2,
    first_k_dense_replace=1, routed_scaling_factor=2.5,
)
FAMILIES = {"llama": {}, "mixtral": MIXTRAL, "deepseek": DEEPSEEK}
# (family, runtime_format, calibration tokens) of each checkpoint
CASES = {
    "int8": ("llama", "int8", None),
    "int4": ("llama", "int4", None),
    "int3": ("llama", "int3", None),
    "int2": ("llama", "int2", None),
    "bf16": ("llama", "bf16", None),
    "int2-mixed": ("llama", "int2-mixed", 128),
    "int3-mixed": ("llama", "int3-mixed", 128),
    "int4-mixed": ("llama", "int4-mixed", 128),
    "mixtral-int8": ("mixtral", "int8", None),
    "deepseek-int8": ("deepseek", "int8", None),
    "deepseek-int4": ("deepseek", "int4", None),
}


@pytest.fixture(scope="module", autouse=True)
def jax_pallas():
    """vptq_tpu's Pallas kernels in interpret mode (its other path does
    not round activations to bf16, as the port's kernels do) and its
    numpy encoders, for the whole module: the JAX models are loaded
    once and shared by its tests."""
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
    return tmp_path_factory.mktemp("runtime")


@functools.lru_cache(maxsize=None)
def _checkpoint(root: str, family: str) -> str:
    path = f"{root}/ckpt_{family}"
    cfg = dict(TINY, tie_word_embeddings=False, **FAMILIES[family])
    jsc.write_synthetic_checkpoint(
        path, jsc.tiny_model_config(**cfg), vq_kwargs=VQ, seed=6)
    return path


@functools.lru_cache(maxsize=None)
def _jax_export(root: str, case: str):
    """(vptq_tpu model, the runtime checkpoint it wrote) of one case."""
    family, fmt, calibration = CASES[case]
    kwargs = {} if calibration is None else dict(calibration=calibration)
    # calibration's forward passes need no Pallas: they only choose codes
    qm = sys.modules["vptq_tpu.ops.quant_matmul"]
    impl, qm._IMPL = qm._IMPL, "xla"
    try:
        jmodel = j_load_model(_checkpoint(root, family), dtype=jnp.float32,
                              runtime_format=fmt, **kwargs)
    finally:
        qm._IMPL = impl
    out = f"{root}/rt_{case}"
    jexport.export_runtime(jmodel, out)
    return jmodel, out


def _bytes(a) -> np.ndarray:
    """The raw bytes of a numpy array (bf16 included) or a CPU tensor."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _assert_same_tensors(jax_flat: dict, port_flat: dict):
    assert sorted(jax_flat) == sorted(port_flat)
    for k, a in jax_flat.items():
        t = port_flat[k]
        assert tuple(a.shape) == tuple(t.shape), k
        assert (a.dtype.name == "bfloat16") == (t.dtype == torch.bfloat16), k
        np.testing.assert_array_equal(_bytes(a), _bytes(t), err_msg=k)


def _logits_close(got: np.ndarray, want: np.ndarray):
    np.testing.assert_allclose(
        got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("case", [c for c in CASES if c != "deepseek-int4"])
def test_jax_runtime_checkpoint_loads_in_the_port(workdir, case):
    jmodel, path = _jax_export(str(workdir), case)
    model = texport.load_runtime_model(path, device="cpu")
    assert model.cfg == tl.ModelConfig.from_dict(
        dataclasses.asdict(jmodel.cfg))
    _assert_same_tensors(jexport._flatten_model(jmodel),
                         texport._flatten_model(model))
    if case.endswith("-mixed") and case != "int4-mixed":
        kind = (trt.Int2MixedLinear if case == "int2-mixed"
                else trt.Int3MixedLinear)
        assert type(model.blocks[0].attn.qkv_proj) is kind
    if case.startswith("deepseek"):
        assert isinstance(model.blocks[0].attn, tl.MlaAttention)
        assert isinstance(model.blocks[1].mlp, tl.DeepseekMoe)
        assert model.blocks[1].mlp.stacked.fmt == "int8"

    tokens = np.random.default_rng(0).integers(0, TINY["vocab_size"], (1, 7))
    want, _ = jax.jit(functools.partial(j_forward, dtype=jnp.float32))(
        jmodel, jnp.asarray(tokens, jnp.int32),
        j_init_cache(jmodel.cfg, 1, 16, jnp.float32),
    )
    with torch.inference_mode():
        got, _ = tl.forward(
            model, torch.from_numpy(tokens),
            tl.init_cache(model.cfg, 1, 16, torch.float32, "cpu"),
            dtype=torch.float32,
        )
    _logits_close(got.numpy(), np.asarray(want))

    # one prefill bucket and one decode chunk size: two JAX compilations
    prompt = np.random.default_rng(3).integers(0, TINY["vocab_size"], 12)
    want = JGenerator(
        jmodel, max_seq=64, dtype=jnp.float32, prompt_buckets=(16,)
    ).generate(prompt, max_new_tokens=9, chunk_size=4)
    got = Generator(
        model, max_seq=64, dtype=torch.float32, prompt_buckets=(16,)
    ).generate(prompt, max_new_tokens=9, chunk_size=4)
    assert len(want) == 9 and got == want


def _port_model(root: str, case: str):
    """A model the port made itself: loaded from the VPTQ checkpoint in a
    re-encoded format, or a mixed model of random codes."""
    family, fmt, _ = CASES[case]
    if fmt.endswith("-mixed"):
        cfg = tl.ModelConfig(**dict(TINY, tie_word_embeddings=False))
        return mixed_model(cfg, fmt, "cpu", seed=2, dtype=torch.float32)
    return load_model(_checkpoint(root, family), dtype=torch.float32,
                      runtime_format=fmt, device="cpu")


@pytest.mark.parametrize("case", [
    "int8", "int4", "int3", "int2", "bf16", "int2-mixed", "int3-mixed",
    "mixtral-int8", "deepseek-int4",
])
def test_port_runtime_checkpoint_loads_in_jax(workdir, case):
    model = _port_model(str(workdir), case)
    out = workdir / f"port_{case}"
    texport.export_runtime(model, out)
    jmodel = jexport.load_runtime_model(str(out))
    assert jmodel.cfg == JModelConfig(**model.cfg.to_dict())
    if not case.endswith("-mixed"):
        # the same config as vptq_tpu's own load of the checkpoint
        assert jmodel.cfg == _jax_export(str(workdir), case)[0].cfg
    _assert_same_tensors(jexport._flatten_model(jmodel),
                         texport._flatten_model(model))
    with open(out / "runtime_config.json") as f:
        meta = json.load(f)
    assert meta["format_version"] == 1
    assert sorted(meta["bf16_keys"]) == sorted(
        k for k, t in texport._flatten_model(model).items()
        if t.dtype == torch.bfloat16)


def _mixed_case(rng, kind: str, out_f: int, in_f: int, cols):
    """Codes, f32 scales (bf16-exact) and side of one mixed layer."""
    lo, group = (-2, 64) if kind == "int2" else (-4, 128)
    q = rng.integers(lo, -lo, (out_f, in_f)).astype(np.int8)
    s = (0.01 * (0.5 + rng.random((out_f, in_f // group)))).astype(
        jnp.bfloat16).astype(np.float32)
    q8 = rng.integers(-127, 128, (out_f, len(cols))).astype(np.int8)
    s8 = (1e-4 * (0.5 + rng.random((out_f, len(cols) // 128)))).astype(
        np.float32)
    return q, s, q8, s8


def _mixed_pair(rng, kind, out_f, in_f, cols):
    """The same mixed layer in vptq_tpu and in the port."""
    q, s, q8, s8 = _mixed_case(rng, kind, out_f, in_f, cols)
    jk = jrt.Int2MixedLinear if kind == "int2" else jrt.Int3MixedLinear
    tk = trt.Int2MixedLinear if kind == "int2" else trt.Int3MixedLinear
    jbase = getattr(jrt, f"{kind}_from_q")(q, s)
    tbase = getattr(trt, f"{kind}_from_q")(torch.from_numpy(q),
                                           torch.from_numpy(s))
    j = jk(jbase, jrt.int8_from_q(q8, s8), jnp.asarray(cols))
    t = tk(tbase, trt.int8_from_q(torch.from_numpy(q8), torch.from_numpy(s8)),
           torch.from_numpy(cols))
    return j, t


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("kind", ["int2", "int3"])
def test_mixed_layers_match_jax(kind, fused):
    """The port's mixed layer against vptq_tpu's on the same numpy-seeded
    codes and x: equal bytes, outputs within 1e-5 of the max; fused q|k|v
    (one column selection) fuse base and side apart, and members whose
    columns differ do not fuse, in both packages."""
    rng = np.random.default_rng(11)
    in_f = 384
    cols = np.sort(rng.choice(in_f, 128, replace=False)).astype(np.int32)
    pairs = [_mixed_pair(rng, kind, out_f, in_f, cols)
             for out_f in ((64, 32, 32) if fused else (48,))]
    jl, tl_ = pairs[0]
    if fused:
        jl = jrt.fuse_linears([j for j, _ in pairs])
        tl_ = trt.fuse_linears([t for _, t in pairs])
        assert type(tl_) is type(pairs[0][1]) and tl_.out_features == 128
        other = _mixed_pair(rng, kind, 32, in_f, (cols + 1) % in_f)
        assert trt.fuse_linears([pairs[0][1], other[1]]) is None
        assert jrt.fuse_linears([pairs[0][0], other[0]]) is None
    for part in ("base", "int8"):
        jpart = getattr(jl, kind if part == "base" else "int8")
        tpart = getattr(tl_, part)
        for name, t in tpart.named_buffers():
            np.testing.assert_array_equal(
                _bytes(np.asarray(getattr(jpart, name))), _bytes(t),
                err_msg=name)
    np.testing.assert_array_equal(np.asarray(jl.col_idx), tl_.col_idx.numpy())
    x = np.random.default_rng(5).standard_normal((3, in_f)).astype(np.float32)
    want = np.asarray(jl(jnp.asarray(x)))
    with torch.inference_mode():
        got = tl_(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("kind,in_f,group", [
    ("int8", 384, 128), ("int8", 1024, 512), ("int4", 384, 128),
    ("int4", 2048, 128), ("int3", 384, 128), ("int2", 448, 64),
    ("int2", 384, 128), ("int2", 1024, 64),
])
def test_from_q_bytes_match_jax(kind, in_f, group):
    """``*_from_q`` byte-equal to vptq_tpu's, padding included (int2's
    codes pad with -1, every format's scales with 1.0)."""
    rng = np.random.default_rng(in_f + group)
    out_f = 24
    lo = {"int8": -127, "int4": -7, "int3": -4, "int2": -2}[kind]
    q = rng.integers(lo, -lo + (kind != "int8"), (out_f, in_f)).astype(
        np.int8)
    s = (0.01 * (0.5 + rng.random((out_f, in_f // group)))).astype(
        np.float32)
    kwargs = dict(group=group) if kind == "int2" else {}
    j = getattr(jrt, f"{kind}_from_q")(q, s, **kwargs)
    t = getattr(trt, f"{kind}_from_q")(torch.from_numpy(q),
                                       torch.from_numpy(s), **kwargs)
    names = [n for n, _ in t.named_buffers()]
    assert names
    for name, buf in t.named_buffers():
        want = np.asarray(getattr(j, name))
        assert want.shape == tuple(buf.shape), name
        np.testing.assert_array_equal(_bytes(want), _bytes(buf),
                                      err_msg=name)


@pytest.mark.parametrize("case", ["int2-mixed", "int3-mixed"])
def test_convert_params_carries_a_calibrated_jax_tree(workdir, case):
    jmodel, path = _jax_export(str(workdir), case)
    with open(f"{_checkpoint(str(workdir), 'llama')}/config.json") as f:
        hf = json.load(f)
    converted = convert_params(jax_params(jmodel), hf, device="cpu")
    assert type(converted.blocks[1].mlp.down_proj) is type(
        texport.load_runtime_model(path, device="cpu").blocks[1].mlp.down_proj)
    _assert_same_tensors(jexport._flatten_model(jmodel),
                         texport._flatten_model(converted))


def test_model_config_reads_what_jax_writes():
    """The port's config from vptq_tpu's dict (llama3 scaling, Mixtral,
    DeepSeek with yarn): rope_scaling a tuple of pairs again, every field
    kept; back in vptq_tpu, equal to the original."""
    scaling = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0,
               "original_max_position_embeddings": 64}
    yarn = {"rope_type": "yarn", "factor": 40.0, "mscale": 1.0,
            "mscale_all_dim": 0.707, "original_max_position_embeddings": 64}
    for extra in (dict(rope_scaling=tuple(sorted(scaling.items()))),
                  MIXTRAL,
                  dict(DEEPSEEK, rope_scaling=tuple(sorted(yarn.items())))):
        jcfg = jsc.tiny_model_config(**TINY, **extra)
        d = json.loads(json.dumps(dataclasses.asdict(jcfg)))
        cfg = tl.ModelConfig.from_dict(d)
        assert isinstance(cfg.rope_scaling, (tuple, type(None)))
        back = dict(cfg.to_dict())
        if back["rope_scaling"]:
            back["rope_scaling"] = tuple(
                (k, v) for k, v in back["rope_scaling"])
        assert JModelConfig(**back) == jcfg
        assert back == dataclasses.asdict(jcfg)
    assert cfg.is_mla and cfg.cache_k_dim == 24 and cfg.rope_dim == 8
    with pytest.raises(ValueError, match="unknown"):
        tl.ModelConfig.from_dict(dict(d, rope_flavour=1))


@pytest.mark.parametrize("kind,shards", [
    ("int4", 2), ("int3", 4), ("int2", 2), ("int8", 2),
])
def test_reader_refuses_a_blocked_layer(workdir, kind, shards):
    """A layer vptq_tpu encoded for tensor-parallel shards: its padded
    width is not the one-device width of its logical in_features. (int3
    over two shards pads each to 1024 and so keeps the one-device width:
    four shards are told apart.)"""
    jmodel, _ = _jax_export(str(workdir), "int8")
    rng = np.random.default_rng(0)
    w = rng.standard_normal((TINY["hidden_size"], TINY["hidden_size"])
                            ).astype(np.float32) * 0.02
    blocked = getattr(jrt, f"_encode_{kind}")(w, None, shards=shards)
    one = getattr(jrt, f"_encode_{kind}")(w, None)
    assert blocked.wq.shape != one.wq.shape if kind in ("int8", "int4") \
        else blocked.in_padded != one.in_padded
    b0 = jmodel.blocks[0]
    model = jmodel.replace(blocks=(
        b0.replace(attn=b0.attn.replace(o_proj=blocked)),
        *jmodel.blocks[1:]))
    out = workdir / f"rt_blocked_{kind}"
    jexport.export_runtime(model, out)
    with pytest.raises(NotImplementedError, match="blocked"):
        texport.load_runtime_model(out, device="cpu")


def test_reader_refuses_shard_local_columns(workdir):
    cfg = tl.ModelConfig(**dict(TINY, tie_word_embeddings=False))
    model = mixed_model(cfg, "int3-mixed", "cpu")
    lin = model.blocks[0].mlp.down_proj
    k = lin.col_idx.numel()
    # two shards' local ids: each half counts from 0 again
    lin.col_idx = torch.cat([lin.col_idx[: k // 2]] * 2)
    texport.export_runtime(model, workdir / "rt_shard_cols")
    with pytest.raises(NotImplementedError, match="strictly increasing"):
        texport.load_runtime_model(workdir / "rt_shard_cols", device="cpu")


def test_reader_refuses_another_format_version(workdir):
    _, path = _jax_export(str(workdir), "int8")
    out = workdir / "rt_v2"
    out.mkdir()
    with open(f"{path}/runtime_config.json") as f:
        meta = json.load(f)
    meta["format_version"] = 2
    with open(out / "runtime_config.json", "w") as f:
        json.dump(meta, f)
    (out / "runtime.safetensors").symlink_to(f"{path}/runtime.safetensors")
    with pytest.raises(ValueError, match="runtime format 2 unsupported"):
        texport.load_runtime_model(out, device="cpu")


def test_writer_refuses_a_codebook_layer(workdir, tmp_path):
    model = load_model(_checkpoint(str(workdir), "llama"),
                       runtime_format="codebook", device="cpu")
    with pytest.raises(ValueError, match="cannot export VQLinear"):
        texport.export_runtime(model, tmp_path / "rt")


def test_cli_on_the_cpu(workdir, tmp_path, capsys):
    """``python -m vptq_tpu_torch.tools.export_runtime ... --device cpu``
    re-encodes on the CPU; vptq_tpu reads what it wrote, byte for byte
    the port's own load in bf16."""
    src = _checkpoint(str(workdir), "llama")
    out = tmp_path / "rt"
    assert texport.main(["-m", src, "-o", str(out), "--runtime-format",
                         "int4", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == f"wrote {out}"
    want = load_model(src, dtype=torch.bfloat16, runtime_format="int4",
                      device="cpu")
    _assert_same_tensors(
        jexport._flatten_model(jexport.load_runtime_model(str(out))),
        texport._flatten_model(want))
