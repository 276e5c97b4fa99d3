"""vptq_tpu_torch's Mixtral MoE path against vptq_tpu.

* The plain versions of the expert and pairs kernels (K6a/K6b, K5a/K5b)
  agree with the Pallas kernels run in interpret mode.
* ``stack_experts`` builds the JAX package's bytes, and refuses what it
  refuses.
* ``_moe_mlp``: the selected-experts path equals the all-experts path on
  the same tokens, and both equal JAX's, at a width the encoders pad;
  constructed router ties pick JAX's experts.
* A Mixtral checkpoint end to end in int8, int4 and bf16: logits and
  greedy tokens equal JAX's, with the all-experts path (a prompt over 64
  tokens) and the selected-experts path (decode) both taken.

The JAX side runs its Pallas kernels in interpret mode (its non-Pallas
path does not round activations to bf16, as the kernels do) and its
numpy encoders.
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
from vptq_tpu.layers import runtime as jrt
from vptq_tpu.layers.dense import DenseLinear as JDense
from vptq_tpu.models import llama as jl
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.ops import pallas_gemm as jpg
from vptq_tpu.serving.generate import Generator as JGenerator
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu_torch.convert import convert_params
from vptq_tpu_torch.layers import runtime as trt
from vptq_tpu_torch.layers.dense import DenseLinear
from vptq_tpu_torch.models import llama as tl
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.ops.w4_matmul_expert import w4_matmul_expert
from vptq_tpu_torch.ops.w4_matmul_pairs import w4_matmul_pairs
from vptq_tpu_torch.ops.w8_matmul_expert import w8_matmul_expert
from vptq_tpu_torch.ops.w8_matmul_pairs import w8_matmul_pairs
from vptq_tpu_torch.serving.generate import Generator
from vptq_tpu_torch.utils import synth_checkpoint as tsc

# 2 layers, 4 experts, top-2 on the tiny Llama geometry
MIXTRAL = dict(
    TINY, model_type="mixtral", num_local_experts=4, num_experts_per_tok=2,
    tie_word_embeddings=False,
)


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(native, "_lib", lambda: None)
    monkeypatch.setattr(
        sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL", "pallas"
    )
    monkeypatch.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
    yield
    # jit caches are keyed on shapes, not on the switch: a trace made
    # here would serve a later test at the same shapes on the XLA path
    jax.clear_caches()


def _bits(a):
    """Bytes of a numpy or torch array (bf16 included)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _tensor(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _expert_weights(rng, n, hidden, inter):
    """Per expert: (gate|up (2·inter, hidden), down (hidden, inter)) f32."""
    def normal(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    return [
        (normal(2 * inter, hidden), normal(hidden, inter)) for _ in range(n)
    ]


def _experts(weights, fmt):
    """The same experts in both packages, each encoded by its own
    package's encoder: (JAX Mlps, port Mlps)."""
    jenc = getattr(jrt, f"_encode_{fmt}")
    tenc = getattr(trt, f"_encode_{fmt}")
    jexperts = tuple(
        jl.Mlp(gate_proj=None, up_proj=None, down_proj=jenc(d, None),
               gate_up_proj=jenc(gu, None))
        for gu, d in weights
    )
    texperts = [
        tl.Mlp(None, None, tenc(torch.from_numpy(d), None),
               tenc(torch.from_numpy(gu), None))
        for gu, d in weights
    ]
    return jexperts, texperts


# ------------------------------------------------- the four plain versions


def _stack(rng, fmt, n_experts, out_f, in_f):
    """A stacked weight of ``fmt`` made by the JAX numpy encoder."""
    layers = [
        getattr(jrt, f"_encode_{fmt}")(
            (0.05 * rng.standard_normal((out_f, in_f))).astype(np.float32),
            None,
        )
        for _ in range(n_experts)
    ]
    return (np.stack([np.asarray(m.wq) for m in layers]),
            np.stack([np.asarray(m.scales) for m in layers]))


@pytest.mark.parametrize("tokens", [1, 5, 20])
@pytest.mark.parametrize("fmt,out_f,in_f", [
    ("int8", 320, 1024), ("int8", 72, 1536), ("int4", 264, 2048),
])
def test_expert_plain_version_matches_pallas(jax_pallas, fmt, out_f, in_f,
                                             tokens):
    """K6a / K6b's plain versions against the Pallas kernels (interpret
    mode), f32 outputs: both sum f32 products of bf16-rounded x with exact
    levels and scale each group's partial, in another order."""
    rng = np.random.default_rng(out_f + tokens)
    n_experts = 3
    wq, scales = _stack(rng, fmt, n_experts, out_f, in_f)
    in_p = wq.shape[2] * (2 if fmt == "int4" else 1)
    x = rng.standard_normal((tokens, in_p)).astype(np.float32)
    fn, jfn = {
        "int8": (w8_matmul_expert, jpg.w8_matmul_expert),
        "int4": (w4_matmul_expert, jpg.w4_matmul_expert),
    }[fmt]
    # the tiles the JAX model picks (llama.py:_expert_matmul)
    in_tile = 2048 if fmt == "int4" else x.shape[1] // scales.shape[1]
    for e in (0, n_experts - 1):
        want = np.asarray(jfn(
            jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scales),
            jnp.asarray(e, jnp.int32), out_tile=256, in_tile=in_tile,
            out_dtype=jnp.float32,
        ))
        got = fn(
            torch.from_numpy(x), _tensor(wq), _tensor(scales),
            torch.tensor(e, dtype=torch.int32), out_dtype=torch.float32,
        ).numpy()
        assert got.shape == (tokens, out_f)
        np.testing.assert_allclose(
            got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max()
        )


# the ids of the pairs cases; the stack holds max(4, max id + 1) experts.
# After the first three, the patterns that share experts among pairs, as
# K5a's kernel groups them: 8 tokens' distinct top-2 over 8 experts (P =
# 16), 8 tokens' top-6 over 64 (P = 48), every pair on one expert
PAIRS_IDS = [
    [2, 2, 0, 3, 1, 3], [3], [0, 1, 2, 3],
    sum(([t % 8, (3 * t + 5) % 8] for t in range(8)), []),
    [(9 * t + 13 * k + 7) % 64 for t in range(8) for k in range(6)] + [63],
    [2] * 12,
]


@pytest.mark.parametrize("ids", PAIRS_IDS)
@pytest.mark.parametrize("fmt,out_f,in_f", [
    ("int8", 320, 1024), ("int4", 264, 2048),
])
def test_pairs_plain_version_matches_pallas(jax_pallas, fmt, out_f, in_f, ids):
    """K5a / K5b's plain versions against the Pallas kernels (interpret
    mode): repeated ids, one pair, all experts once, and pairs sharing
    experts: 16 over 8, 49 over 64, 12 on one."""
    rng = np.random.default_rng(out_f + len(ids))
    wq, scales = _stack(rng, fmt, max(4, max(ids) + 1), out_f, in_f)
    x = rng.standard_normal((len(ids), in_f)).astype(np.float32)
    fn, jfn = {
        "int8": (w8_matmul_pairs, jpg.w8_matmul_pairs),
        "int4": (w4_matmul_pairs, jpg.w4_matmul_pairs),
    }[fmt]
    in_tile = 2048 if fmt == "int4" else in_f // scales.shape[1]
    want = np.asarray(jfn(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scales),
        jnp.asarray(ids, jnp.int32), out_tile=256, in_tile=in_tile,
        out_dtype=jnp.float32,
    ))
    got = fn(
        torch.from_numpy(x), _tensor(wq), _tensor(scales),
        torch.tensor(ids, dtype=torch.int64), out_dtype=torch.float32,
    ).numpy()
    assert got.shape == (len(ids), out_f)
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max()
    )


def test_wrappers_refuse_bad_shapes():
    wq = torch.zeros((2, 8, 512), dtype=torch.int8)
    s8 = torch.ones((2, 1, 8))
    x = torch.zeros((3, 512))
    one = torch.tensor(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="one id"):
        w8_matmul_expert(x, wq, s8, torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="one expert id per row"):
        w8_matmul_pairs(x, wq, s8, torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="3-D int8"):
        w8_matmul_expert(x, wq[0], s8[0], one)
    with pytest.raises(ValueError, match="scales"):
        w4_matmul_expert(x, wq, s8, one)
    with pytest.raises(ValueError, match="one expert id per row"):
        w4_matmul_pairs(
            x[None].expand(2, 3, 512), wq[:, :, :256],
            torch.ones((2, 4, 8), dtype=torch.bfloat16), torch.tensor([0, 1]),
        )


# ---------------------------------------------------------- stack_experts


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_stack_experts_byte_equal(jax_pallas, fmt):
    rng = np.random.default_rng(7)
    jexperts, texperts = _experts(_expert_weights(rng, 4, 96, 160), fmt)
    want = jrt.stack_experts(jexperts)
    got = trt.stack_experts(texperts)
    assert got.fmt == want.fmt == fmt
    for name in ("gate_up_wq", "gate_up_scales", "down_wq", "down_scales"):
        w, g = getattr(want, name), getattr(got, name)
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)
    assert got.expert_ids.tolist() == [0, 1, 2, 3]
    assert got.expert_ids.dtype == torch.int32


def test_stack_experts_refuses_what_does_not_stack():
    rng = np.random.default_rng(8)
    weights = _expert_weights(rng, 3, 64, 128)
    _, int8 = _experts(weights, "int8")
    _, int4 = _experts(weights, "int4")
    assert trt.stack_experts(int8) is not None
    # mixed families
    assert trt.stack_experts(int8[:2] + int4[2:]) is None
    mixed = tl.Mlp(None, None, int4[0].down_proj, int8[0].gate_up_proj)
    assert trt.stack_experts([mixed, mixed]) is None
    # a format that has no stacked kernel
    dense = tl.Mlp(
        None, None,
        DenseLinear(torch.zeros((64, 128), dtype=torch.bfloat16)),
        DenseLinear(torch.zeros((256, 64), dtype=torch.bfloat16)),
    )
    assert trt.stack_experts([dense, dense]) is None
    # a bias
    _, biased = _experts(weights, "int8")
    biased[1].down_proj.bias = torch.zeros(64)
    assert trt.stack_experts(biased) is None
    # unequal shapes
    _, wider = _experts(_expert_weights(rng, 1, 64, 600), "int8")
    assert trt.stack_experts(int8[:2] + wider) is None


def test_fuse_block_stacks_and_drops_the_expert_copies():
    rng = np.random.default_rng(9)

    def moe(fmt):
        experts = []
        for gu, d in _expert_weights(rng, 4, 64, 128):
            enc = getattr(trt, f"_encode_{fmt}")
            gate, up = np.split(gu, 2)
            experts.append(tl.Mlp(
                enc(torch.from_numpy(gate.copy()), None),
                enc(torch.from_numpy(up.copy()), None),
                enc(torch.from_numpy(d), None),
            ))
        router = DenseLinear(torch.zeros((4, 64)))
        return tl.MoeMlp(router, experts, num_experts_per_tok=2)

    attn = tl.Attention(None, None, None, DenseLinear(torch.zeros((64, 64))),
                        qkv_proj=DenseLinear(torch.zeros((128, 64))))
    ones = torch.ones(64)
    for fmt, stacks in (("int8", True), ("int4", True), ("int2", False)):
        block = trt.fuse_block(tl.Block(ones, attn, ones, moe(fmt)))
        mlp = block.mlp
        if stacks:
            assert len(mlp.experts) == 0 and mlp.stacked.fmt == fmt
            assert mlp.stacked.gate_up_wq.shape[:2] == (4, 256)
        else:  # gate|up fused per expert, the experts kept
            assert mlp.stacked is None and len(mlp.experts) == 4
            assert all(e.gate_proj is None and e.gate_up_proj is not None
                       for e in mlp.experts)


# --------------------------------------------------------------- _moe_mlp


def _moe_pair(rng, fmt, hidden, inter, n_experts=4, k=2, router=None):
    """One MoE block in both packages: (JAX MoeMlp, port MoeMlp), stacked."""
    jexperts, texperts = _experts(
        _expert_weights(rng, n_experts, hidden, inter), fmt
    )
    if router is None:
        router = (0.5 * rng.standard_normal((n_experts, hidden)))
    router = router.astype(np.float32)
    jmoe = jl.MoeMlp(
        router=JDense(weight=jnp.asarray(router)), experts=(),
        num_experts_per_tok=k,
        stacked=jax.tree_util.tree_map(
            jnp.asarray, jrt.stack_experts(jexperts)
        ),
    )
    tmoe = tl.MoeMlp(
        DenseLinear(torch.from_numpy(router)), [], num_experts_per_tok=k,
        stacked=trt.stack_experts(texperts),
    )
    return jmoe, tmoe


def _count_calls(monkeypatch):
    """Count the expert (K6) and pairs (K5) calls the port's model makes."""
    calls = {"expert": 0, "pairs": 0}

    def counted(kind, fn):
        def wrapper(*args, **kwargs):
            calls[kind] += 1
            return fn(*args, **kwargs)
        return wrapper

    for kind, table in (("expert", tl._EXPERT_MATMUL),
                        ("pairs", tl._PAIRS_MATMUL)):
        for fmt, fn in list(table.items()):
            monkeypatch.setitem(table, fmt, counted(kind, fn))
    return calls


# hidden 96 and inter 160 are widths every encoder pads (int8 to its
# group of 512, int4 to 2048), so x is padded in both matmuls
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_moe_fast_path_equals_dense_path_and_jax(jax_pallas, monkeypatch, fmt):
    rng = np.random.default_rng(11)
    hidden, inter = 96, 160
    jmoe, tmoe = _moe_pair(rng, fmt, hidden, inter)
    x = rng.standard_normal((1, 6, hidden)).astype(np.float32)
    calls = _count_calls(monkeypatch)

    fast = tl._moe_mlp(tmoe, torch.from_numpy(x)).numpy()
    assert calls == {"expert": 0, "pairs": 2}
    want_fast = np.asarray(jl._moe_mlp(jmoe, jnp.asarray(x)))
    # the same tokens through the all-experts path of both packages
    monkeypatch.setattr(tl, "_MOE_FAST_MAX_TOKENS", 0)
    monkeypatch.setattr(jl, "_MOE_FAST_MAX_TOKENS", 0)
    dense = tl._moe_mlp(tmoe, torch.from_numpy(x)).numpy()
    assert calls == {"expert": 8, "pairs": 2}
    want_dense = np.asarray(jl._moe_mlp(jmoe, jnp.asarray(x)))

    assert fast.shape == x.shape
    tol = 1e-5 * np.abs(want_dense).max()
    # f32 throughout; only summation orders differ
    np.testing.assert_allclose(fast, want_fast, rtol=1e-5, atol=tol)
    np.testing.assert_allclose(dense, want_dense, rtol=1e-5, atol=tol)
    np.testing.assert_allclose(fast, dense, rtol=1e-5, atol=tol)


def test_threshold_between_the_two_paths(monkeypatch):
    rng = np.random.default_rng(12)
    _, tmoe = _moe_pair(rng, "int8", 64, 128)
    calls = _count_calls(monkeypatch)
    tl._moe_mlp(tmoe, torch.zeros((1, 64, 64)))
    assert calls == {"expert": 0, "pairs": 2}
    tl._moe_mlp(tmoe, torch.zeros((1, 65, 64)))
    assert calls == {"expert": 8, "pairs": 2}


def test_top_k_ties_resolve_as_jax():
    rng = np.random.default_rng(13)
    # few distinct values: most rows hold ties, many across the k-th place
    logits = rng.integers(-2, 3, (200, 8)).astype(np.float32)
    logits[0] = 0.0
    logits[1] = [1, 3, 3, 3, 0, 3, 1, 1]
    for k in (1, 2, 3):
        want_w, want_ids = jax.lax.top_k(jnp.asarray(logits), k)
        got_w, got_ids = tl._top_k(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    assert tl._top_k(torch.from_numpy(logits[1]), 2)[1].tolist() == [1, 2]


@pytest.mark.parametrize("tokens", [5, 70])
def test_bf16_router_ties_pick_jax_experts(jax_pallas, tokens):
    """In bf16 the router's logits tie; with one row of the router held by
    three experts they tie across the k-th place in every token, and
    another choice among the tied experts would give another output."""
    rng = np.random.default_rng(14)
    hidden, inter = 64, 128
    rows = 0.5 * rng.standard_normal((2, hidden))
    router = rows[[0, 0, 0, 1]]  # experts 0 = 1 = 2 in every token
    jmoe, tmoe = _moe_pair(rng, "int8", hidden, inter, router=router)
    x = rng.standard_normal((1, tokens, hidden)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jl._moe_mlp(jmoe, xb).astype(jnp.float32))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = tl._moe_mlp(tmoe, tx).to(torch.float32).numpy()
    logits = tmoe.router(tx).to(torch.float32)
    assert bool((logits[..., 0] == logits[..., 2]).all())
    # of the three tied experts the last is never taken
    assert tl._top_k(logits, 2)[1].unique().tolist() == [0, 1, 3]
    # bf16 outputs: one ulp of the final rounding
    np.testing.assert_allclose(
        got, want, rtol=1e-2, atol=1e-2 * np.abs(want).max()
    )


# ------------------------------------------------------------- end to end


def _checkpoint(path, seed, **overrides):
    jsc.write_synthetic_checkpoint(
        path, jsc.tiny_model_config(**dict(MIXTRAL, **overrides)),
        vq_kwargs=VQ, seed=seed,
    )
    return str(path)


def _assert_logits_close(got, want):
    """f32 logits of the two packages: 1e-4 of max |logit|, but for a few
    rows 2e-3. Both round activations to bf16 inside every kernel, so an
    activation that differs in its last f32 bit across a bf16 rounding
    edge moves one product by 2^-9 of itself; with 4 experts' matmuls
    per token and layer a prompt of 70 tokens meets a few such edges."""
    scale = np.abs(want).max()
    err = np.abs(got - want).reshape(-1, want.shape[-1]).max(axis=-1)
    assert err.max() <= 2e-3 * scale, err.max() / scale
    loose = int((err > 1e-4 * scale).sum())
    assert loose <= max(1, len(err) // 10), (loose, len(err))


def test_synthetic_mixtral_checkpoint_equals_jax_writer(tmp_path):
    _checkpoint(tmp_path / "jax", seed=3)
    tsc.write_synthetic_checkpoint(
        tmp_path / "port", tsc.tiny_model_config(**MIXTRAL), vq_kwargs=VQ,
        seed=3,
    )
    want = safetensors.numpy.load_file(tmp_path / "jax" / "model.safetensors")
    got = safetensors.numpy.load_file(tmp_path / "port" / "model.safetensors")
    assert sorted(got) == sorted(want)
    assert "model.layers.1.block_sparse_moe.experts.3.w2.indices" in got
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(got[name], arr, err_msg=name)

    def config(side):
        with open(tmp_path / side / "config.json") as f:
            return json.load(f)

    jconf, tconf = config("jax"), config("port")
    assert {k: jconf[k] for k in tconf} == tconf
    assert tconf["num_local_experts"] == 4
    assert tconf["architectures"] == ["MixtralForCausalLM"]


@pytest.mark.parametrize("fmt", ["int8", "int4", "bf16"])
def test_mixtral_logits_and_greedy_tokens_identical(tmp_path, jax_pallas,
                                                    monkeypatch, fmt):
    path = _checkpoint(tmp_path, seed=21)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, MIXTRAL["vocab_size"], 70)  # over 64 tokens
    buckets = (16, 80)

    jmodel = j_load_model(path, dtype=jnp.float32, runtime_format=fmt)
    tmodel = load_model(
        path, dtype=torch.float32, runtime_format=fmt, device="cpu"
    )
    mlp = tmodel.blocks[0].mlp
    assert isinstance(mlp, tl.MoeMlp) and mlp.num_experts_per_tok == 2
    stacks = fmt != "bf16"
    assert (mlp.stacked is not None) == stacks
    assert len(mlp.experts) == (0 if stacks else 4)

    # logits of the prompt: the all-experts path (the selected-experts
    # path's logits are held in test_convert_of_fused_mixtral_...)
    calls = _count_calls(monkeypatch)
    layers, experts = 2, 4
    want, _ = jl.forward(
        jmodel, jnp.asarray(prompt[None, :], jnp.int32),
        jl.init_cache(jmodel.cfg, 1, 96, jnp.float32), dtype=jnp.float32,
    )
    with torch.inference_mode():
        got, _ = tl.forward(
            tmodel, torch.from_numpy(prompt[None, :]),
            tl.init_cache(tmodel.cfg, 1, 96, torch.float32, "cpu"),
            dtype=torch.float32,
        )
    _assert_logits_close(got.numpy(), np.asarray(want))
    per_prefill = 2 * experts * layers if stacks else 0
    assert calls == {"expert": per_prefill, "pairs": 0}

    new = 6
    want = JGenerator(
        jmodel, max_seq=96, dtype=jnp.float32, prompt_buckets=buckets
    ).generate(prompt, max_new_tokens=new, chunk_size=5)
    got = Generator(
        tmodel, max_seq=96, dtype=torch.float32, prompt_buckets=buckets
    ).generate(prompt, max_new_tokens=new, chunk_size=5)
    assert len(want) == new
    assert got == want
    # one more prefill through the expert kernels, every decode step
    # through the pairs kernels
    per_step = 2 * layers if stacks else 0
    assert calls == {
        "expert": 2 * per_prefill, "pairs": per_step * (new - 1)
    }


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_convert_of_fused_mixtral_gives_loader_logits(tmp_path, jax_pallas,
                                                      fmt):
    path = _checkpoint(tmp_path, seed=22)
    jmodel = j_load_model(path, dtype=jnp.float32, runtime_format=fmt)
    with open(tmp_path / "config.json") as f:
        hf = json.load(f)
    converted = convert_params(jax_params(jmodel), hf, device="cpu")
    loaded = load_model(
        path, dtype=torch.float32, runtime_format=fmt, device="cpu"
    )
    for model in (converted, loaded):
        mlp = model.blocks[1].mlp
        assert mlp.stacked.fmt == fmt and len(mlp.experts) == 0
        assert isinstance(mlp.router, DenseLinear)
    for (name, a), (_, b) in zip(converted.named_buffers(),
                                 loaded.named_buffers()):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)

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
    want, _ = jl.forward(
        jmodel, jnp.asarray(tokens, jnp.int32),
        jl.init_cache(jmodel.cfg, 1, 16, jnp.float32), dtype=jnp.float32,
    )
    _assert_logits_close(outs[0], np.asarray(want))


def test_convert_of_unfused_mixtral_keeps_the_experts(tmp_path, jax_pallas):
    path = _checkpoint(tmp_path, seed=23)
    jmodel = j_load_model(
        path, dtype=jnp.float32, runtime_format="int8", fuse=False
    )
    with open(tmp_path / "config.json") as f:
        hf = json.load(f)
    converted = convert_params(jax_params(jmodel), hf, device="cpu")
    mlp = converted.blocks[0].mlp
    assert mlp.stacked is None and len(mlp.experts) == 4
    assert isinstance(mlp.experts[3].gate_proj, trt.Int8Linear)
    trt.fuse_model(converted)
    assert mlp.stacked.fmt == "int8" and len(mlp.experts) == 0


def test_convert_refuses_a_stack_of_no_known_format():
    from vptq_tpu_torch.convert import _stacked_format

    wq = np.zeros((4, 8, 512), np.int8)
    f32 = np.zeros((4, 1, 8), np.float32)
    params = {"s.gate_up_wq": wq, "s.gate_up_scales": f32,
              "s.down_wq": wq, "s.down_scales": f32}
    assert _stacked_format("s", params) == "int8"
    params["s.down_scales"] = np.zeros((4, 8, 8), np.float16)
    with pytest.raises(ValueError, match="cannot tell"):
        _stacked_format("s", params)


# ------------------------------------------------------ what still raises


def _edit_config(path, **changes):
    with open(path / "config.json") as f:
        hf = json.load(f)
    hf.update(changes)
    with open(path / "config.json", "w") as f:
        json.dump(hf, f)


@pytest.mark.parametrize("changes,match", [
    (dict(model_type="phi3"), "MoE of model_type 'phi3'"),
    (dict(model_type="phimoe"), "phimoe"),
])
def test_other_moe_families_still_raise(tmp_path, changes, match):
    _checkpoint(tmp_path, seed=1)
    _edit_config(tmp_path, **changes)
    with pytest.raises(NotImplementedError, match=match):
        load_model(str(tmp_path), runtime_format="int8", device="cpu")


@pytest.mark.parametrize("fmt", ["int4-mixed", "int3-mixed", "int2-mixed"])
def test_calibrated_formats_still_raise_for_mixtral(tmp_path, fmt):
    """(Named when these formats raised.) A Mixtral checkpoint calibrates
    in each (128 synthetic tokens) and generates: mixed experts keep their
    per-expert layers (the all-experts path), int4-mixed stacks them when
    every expert site is int4 (tests/test_torch_calibrate.py holds the
    codes to JAX's)."""
    path = _checkpoint(tmp_path, seed=1)
    model = load_model(path, dtype=torch.float32, runtime_format=fmt,
                       calibration=128, device="cpu")
    for block in model.blocks:
        moe = block.mlp
        if fmt == "int4-mixed":
            stacked = moe.stacked is not None
            assert stacked == (not len(moe.experts))
        else:
            assert moe.stacked is None and len(moe.experts) == 4
            assert type(moe.experts[0].gate_up_proj).__name__ == (
                "Int2MixedLinear" if fmt == "int2-mixed" else
                "Int3MixedLinear")
    out = Generator(model, max_seq=64, dtype=torch.float32).generate(
        [1, 2, 3, 4, 5], max_new_tokens=6)
    assert len(out) == 6 and all(0 <= t < TINY["vocab_size"] for t in out)


def test_port_writer_refuses_other_moe_layouts(tmp_path):
    with pytest.raises(NotImplementedError, match="Mixtral"):
        tsc.write_synthetic_checkpoint(
            tmp_path, tsc.tiny_model_config(num_local_experts=4)
        )
    with pytest.raises(NotImplementedError, match="Mixtral"):
        tsc.write_synthetic_checkpoint(
            tmp_path, tsc.tiny_model_config(model_type="mixtral")
        )
