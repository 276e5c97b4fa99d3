"""vptq_tpu_torch stands alone, picks its device, and chip_smoke.py's
phases run at a tiny size on the CPU with the plain versions.

Tests marked ``cuda`` need an NVIDIA GPU; they skip elsewhere. This file
imports no JAX, so a machine with a GPU and no JAX runs them with
``python -m pytest --noconftest tests/test_torch_isolation.py -m cuda``.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_port import LLAMA3_SCALING, TINY, VQ

import chip_smoke
from vptq_tpu_torch import AutoModelForCausalLM
from vptq_tpu_torch.convert import convert_params
from vptq_tpu_torch.ops import _build
from vptq_tpu_torch.ops.bf16_matmul import bf16_matmul, bf16_matmul_reference
from vptq_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from vptq_tpu_torch.ops.w2_matmul import w2_matmul, w2_matmul_reference
from vptq_tpu_torch.ops.w3_matmul import w3_matmul, w3_matmul_reference
from vptq_tpu_torch.ops.w4_matmul import w4_matmul, w4_matmul_reference
from vptq_tpu_torch.ops.w4_matmul_expert import (
    w4_matmul_expert,
    w4_matmul_expert_reference,
)
from vptq_tpu_torch.ops.w4_matmul_pairs import (
    w4_matmul_pairs,
    w4_matmul_pairs_reference,
)
from vptq_tpu_torch.ops.w8_matmul import w8_matmul, w8_matmul_reference
from vptq_tpu_torch.ops.w8_matmul_expert import (
    w8_matmul_expert,
    w8_matmul_expert_reference,
)
from vptq_tpu_torch.ops.w8_matmul_pairs import (
    w8_matmul_pairs,
    w8_matmul_pairs_reference,
)
from vptq_tpu_torch.utils.synth_checkpoint import (
    tiny_model_config,
    write_synthetic_checkpoint,
)

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import vptq_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vptq_tpu_torch.__path__, "vptq_tpu_torch.")]
assert {"vptq_tpu_torch.ops.flash_attention", "vptq_tpu_torch.ops.bf16_matmul"} <= set(names)
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "ml_dtypes", "safetensors", "vptq_tpu")
)
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_vptq_tpu():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.split(maxsplit=1)
    assert int(out[0]) >= 31  # every module of the package was imported
    assert out[1].strip() == "[]"


@pytest.fixture
def checkpoint(tmp_path):
    write_synthetic_checkpoint(
        tmp_path, tiny_model_config(**TINY, tie_word_embeddings=False),
        vq_kwargs=VQ, seed=0,
    )
    return str(tmp_path)


def test_default_device_is_cuda(checkpoint, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutoModelForCausalLM.from_pretrained(checkpoint)
    with open(Path(checkpoint) / "config.json") as f:
        hf = json.load(f)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert_params({}, hf)


def test_cpu_path_launches_no_kernel(checkpoint):
    before = w8_matmul.launches
    engine = AutoModelForCausalLM.from_pretrained(
        checkpoint, device="cpu", dtype=torch.float32, max_seq=64
    )
    out = engine.generate([1, 2, 3], max_new_tokens=5)
    assert len(out) == 5
    assert w8_matmul.launches == before


def test_chip_smoke_phases_on_cpu():
    shapes = [("a", 40, 1024), ("b", 24, 600)]
    kernels = list(chip_smoke.FORMAT_KERNEL.values())
    rows = []
    for name in kernels:
        rows += chip_smoke.phase_kernel(name, "cpu", shapes, tokens=(1, 20),
                                        iters=1)
    assert len(rows) == 16 and all(r["max_abs_err"] == 0.0 for r in rows)
    for fmt in chip_smoke.MOE_KERNELS:
        rows += chip_smoke.phase_moe_kernels(
            fmt, "cpu", shapes, n_experts=4, tokens=(1, 20), pairs=(2, 6),
            iters=1,
        )
    moe_rows = rows[16:]
    # K7 takes widths that 512 divides
    rows += chip_smoke.phase_bf16(
        "cpu", [("a", 40, 1024), ("b", 24, 512)], tokens=(1, 20), iters=1)
    flash_cases = (
        ("heads", 1, 40, 4, 2, 16, 1.0, True),
        ("heads", 1, 70, 4, 2, 16, 1.0, True),
        ("two sequences, big scores", 2, 33, 2, 2, 8, 3.0, False),
    )
    rows += chip_smoke.phase_flash("cpu", cases=flash_cases, iters=1)
    assert all(r["max_abs_err"] == 0.0 for r in rows[32:])
    # v is the view the model hands over: rows 4 + 2 + 2 heads wide
    assert [r["v_row_stride"] for r in rows[-3:]] == [128, 128, 48]
    # bytes: q and out at H heads, k and v at KV heads; operations: both
    # products over the lower triangle with its diagonal
    assert rows[-3]["bytes"] == 2 * 40 * 16 * (4 + 4 + 2 + 2)
    assert rows[-3]["flops"] == 4 * 16 * 4 * (40 * 41 // 2)
    assert len(moe_rows) == 16
    assert all(r["max_abs_err"] == 0.0 for r in moe_rows)
    # one token's top-2 are two experts; three tokens' pick at most four
    assert [r["distinct"] for r in moe_rows if r["T"] == 2] == [2] * 4
    assert all(2 <= r["distinct"] <= 4 for r in moe_rows if r["T"] == 6)
    assert set(chip_smoke.ALL_KERNELS) == {r["kernel"] for r in rows}
    assert len(chip_smoke.ALL_KERNELS) == 10
    records = chip_smoke.kernel_records(
        rows, dict.fromkeys(chip_smoke.ALL_KERNELS, 0), tokens=(1, 20),
        pairs=(2, 6), seqs=(40, 70),
    )
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert len(records) == 20 and all(keys <= set(r) for r in records)
    assert [r["name"] for r in records if "flash" in r["name"]] == [
        f"flash_attention (S={n}, one layer's attention at Llama-3.1-8B's "
        "heads)" for n in (40, 70)
    ]
    assert sum(
        "scaled_dot_product_attention" in r["library"] for r in records) == 2
    assert all((ROOT / r["source"]).exists() for r in records)
    assert [r["name"] for r in records if "pairs" in r["name"]] == [
        f"{k} (P={p}, one layer's gate_up and down)"
        for k in ("w8_matmul_pairs", "w4_matmul_pairs") for p in (2, 6)
    ]
    json.dumps(records)

    enc = chip_smoke.phase_encoders("cpu", out_f=16, in_f=1024)
    assert sorted(enc) == ["int2", "int3", "int4"]

    cfg = dict(TINY, tie_word_embeddings=False,
               rope_scaling=tuple(sorted(LLAMA3_SCALING.items())))
    path, _ = chip_smoke.write_checkpoint(cfg, VQ)
    try:
        for fmt in chip_smoke.FORMAT_KERNEL:
            e2e = chip_smoke.phase_e2e(
                "cpu", path, fmt, TINY["vocab_size"], prompt_lens=(5, 20, 40),
                new_tokens=4, max_seq=64,
            )
            assert [r["prompt"] for r in e2e["requests"]] == [5, 20, 40]
            assert "long_prefill_logits_max_abs_diff" not in e2e
            # the CPU runs the plain versions
            assert e2e["launches"] == {chip_smoke.FORMAT_KERNEL[fmt]: 0}
            assert e2e["prefill_logits_max_abs_diff"] == 0.0
            assert e2e["decode_logits_max_abs_diff"] == 0.0
    finally:
        shutil.rmtree(path, ignore_errors=True)

    cfg = dict(TINY, tie_word_embeddings=False, model_type="mixtral",
               num_local_experts=4, num_experts_per_tok=2)
    path, _ = chip_smoke.write_checkpoint(cfg, VQ)
    try:
        for fmt, moe_kernels in chip_smoke.MOE_KERNELS.items():
            e2e = chip_smoke.phase_e2e(
                "cpu", path, fmt, TINY["vocab_size"], prompt_lens=(5, 70),
                new_tokens=3, max_seq=128,
            )
            assert e2e["kernels"] == [
                chip_smoke.FORMAT_KERNEL[fmt], *moe_kernels]
            assert set(e2e["launches"].values()) == {0}
            assert e2e["prefill_logits_max_abs_diff"] == 0.0
            assert e2e["decode_logits_max_abs_diff"] == 0.0
    finally:
        shutil.rmtree(path, ignore_errors=True)


@pytest.mark.parametrize("window", [None, 64], ids=["llama", "mistral"])
def test_chip_smoke_long_prompts_on_cpu(window):
    """The smoke's long requests at a tiny size: a prompt in one fresh
    2048-token chunk and one in two chunks; K8 is on the path unless the
    model has a sliding window, and the long prompt's logits are held
    against the plain versions."""
    cfg = dict(TINY, tie_word_embeddings=False)
    if window:
        cfg.update(model_type="mistral", sliding_window=window)
    path, _ = chip_smoke.write_checkpoint(cfg, VQ)
    try:
        e2e = chip_smoke.phase_e2e(
            "cpu", path, "int8", TINY["vocab_size"],
            prompt_lens=(5, 1030, 2100), new_tokens=3, max_seq=4096,
        )
    finally:
        shutil.rmtree(path, ignore_errors=True)
    assert [r["prompt"] for r in e2e["requests"]] == [5, 1030, 2100]
    if window:
        assert e2e["kernels"] == ["w8_matmul"]
        assert "long_prefill_logits_max_abs_diff" not in e2e
    else:
        assert e2e["kernels"] == ["w8_matmul", "flash_attention"]
        assert e2e["long_prefill_logits_max_abs_diff"] == 0.0
    assert set(e2e["launches"].values()) == {0}  # the CPU launches nothing


def test_expected_launches_of_a_request():
    """The counts the smoke holds each request to: per layer and forward
    call 4 of the format's kernel (dense) or 2 (MoE: qkv, o); per layer
    2 of the pairs kernel for a call of at most 64 tokens and 2·E of the
    expert kernel for a longer one."""
    buckets = [128, 512, 2048]
    dense = tiny_model_config(num_hidden_layers=3)
    got = chip_smoke.expected_launches(dense, "int4", 16, 32, buckets)
    assert got.pop("w4_matmul") == 4 * 3 * 32 and set(got.values()) == {0}
    moe = tiny_model_config(num_hidden_layers=3, model_type="mixtral",
                            num_local_experts=8, num_experts_per_tok=2)
    for prompt in (16, 128, 512):
        got = chip_smoke.expected_launches(moe, "int8", prompt, 32, buckets)
        assert got.pop("w8_matmul") == 2 * 3 * 32
        assert got.pop("w8_matmul_pairs") == 2 * 3 * 31
        assert got.pop("w8_matmul_expert") == 16 * 3 * 1
        assert set(got.values()) == {0}
    # a prompt over the largest bucket is two prefill chunks; a bucket of
    # at most 64 tokens takes the pairs kernel in its prefill too
    got = chip_smoke.expected_launches(moe, "int4", 2050, 2, buckets)
    assert (got["w4_matmul"], got["w4_matmul_expert"],
            got["w4_matmul_pairs"]) == (2 * 3 * 3, 16 * 3 * 2, 2 * 3 * 1)
    got = chip_smoke.expected_launches(moe, "int4", 10, 2, [64])
    assert (got["w4_matmul_expert"], got["w4_matmul_pairs"]) == (0, 2 * 3 * 2)
    # K8: once per layer when the first chunk holds 1024 tokens or more and
    # the model has no sliding window; a later chunk never; K7 never
    for model in (dense, moe):
        fmt = "int8"
        for prompt, want in ((512, 0), (513, 3), (1536, 3), (2047, 3),
                             (4608, 3)):
            got = chip_smoke.expected_launches(model, fmt, prompt, 32, buckets)
            assert (got["flash_attention"], got["bf16_matmul"]) == (want, 0)
    got = chip_smoke.expected_launches(dense, "int8", 1536, 32, buckets)
    assert got["w8_matmul"] == 4 * 3 * 32
    got = chip_smoke.expected_launches(moe, "int8", 1536, 32, buckets)
    assert got["w8_matmul_expert"] == 16 * 3 and got["flash_attention"] == 3
    windowed = tiny_model_config(num_hidden_layers=3, model_type="mistral",
                                 sliding_window=4096)
    got = chip_smoke.expected_launches(windowed, "int8", 4608, 32, buckets)
    assert got.pop("w8_matmul") == 4 * 3 * (3 + 31)
    assert set(got.values()) == {0}
    assert chip_smoke.expected_launches(
        dense, "int8", 1536, 32, [128, 512])["flash_attention"] == 0


def test_k1_shapes_of_qwen25_7b_and_mistral_7b():
    """Qwen2.5-7B's widths make K1 pad and use other scale groups than
    Llama's 2048."""
    from vptq_tpu_torch.layers.runtime import pick_group

    shapes = chip_smoke.k1_shapes(chip_smoke.QWEN25_7B)
    assert shapes == [
        ("qkv", 4608, 3584), ("o", 3584, 3584),
        ("gate_up", 37888, 3584), ("down", 3584, 18944),
    ]
    groups = [pick_group(in_f) for _, _, in_f in shapes]
    assert groups == [512, 512, 512, 1024]
    assert [-(-in_f // g) * g for (_, _, in_f), g in zip(shapes, groups)] == [
        3584, 3584, 3584, 19456]
    qwen = tiny_model_config(**chip_smoke.QWEN25_7B)
    assert qwen.sliding_window is None and qwen.model_type == "qwen2"
    mistral = tiny_model_config(**chip_smoke.MISTRAL_7B)
    assert mistral.sliding_window == 4096
    assert chip_smoke.k1_shapes(chip_smoke.MISTRAL_7B) == chip_smoke.k1_shapes(
        chip_smoke.LLAMA31_8B)


def test_k1_shapes_of_llama31_8b():
    assert chip_smoke.k1_shapes(chip_smoke.LLAMA31_8B) == [
        ("qkv", 6144, 4096), ("o", 4096, 4096),
        ("gate_up", 28672, 4096), ("down", 4096, 14336),
    ]


def test_moe_shapes_of_mixtral_8x7b():
    assert chip_smoke.moe_shapes(chip_smoke.MIXTRAL_8X7B) == [
        ("gate_up", 28672, 4096), ("down", 4096, 14336),
    ]
    cfg = tiny_model_config(**chip_smoke.MIXTRAL_8X7B)
    assert (cfg.num_local_experts, cfg.num_experts_per_tok) == (8, 2)
    assert cfg.sliding_window is None


@pytest.mark.parametrize("name", sorted(chip_smoke.ALL_KERNELS))
def test_kernel_names_its_tpu_kernel_and_trace_tags(name):
    """A wrapper's ``replaces`` points at the Pallas kernel body it ports,
    and its ``trace_tags`` occur in its CUDA sources. No two kernels'
    tags pick the same CUDA kernel names."""
    fn, _ = chip_smoke.kernel_fns(name)
    path, line = fn.replaces.split(":")
    body = (ROOT / path).read_text().splitlines()[int(line) - 1]
    if name == "flash_attention":
        # the JAX package calls the library's Pallas op, it has no body here
        assert body.strip() == "out = flash_attention(", body
    else:
        # _w8_kernel, _w8e_kernel (expert), _w8p_kernel (pairs), _bf16_kernel
        base, _, kind = name.partition("_matmul")
        assert body.startswith(f"def _{base}{kind[1:2]}_kernel("), body
    csrc = ROOT / "vptq_tpu_torch/csrc"
    src = (csrc / f"{name}.cu").read_text()
    assert f'extern "C" int vptq_{name}(' in src
    # the headers it includes, and theirs
    for _ in range(2):
        for header in sorted(csrc.glob("*.cuh")):
            if f'#include "{header.name}"' in src:
                src += header.read_text()
    assert all(tag in src for tag in fn.trace_tags)
    assert name in _build.SOURCES
    others = [chip_smoke.kernel_fns(k)[0].trace_tags
              for k in chip_smoke.ALL_KERNELS if k != name]
    assert all(set(fn.trace_tags) - set(tags) and set(tags) - set(fn.trace_tags)
               for tags in others)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [1, 3, 16, 17, 40])
def test_k1_kernel_matches_plain_version(cuda, tokens):
    gen = torch.Generator(device=cuda).manual_seed(tokens)
    wq = torch.randint(-127, 128, (200, 2048), generator=gen, device=cuda,
                       dtype=torch.int8)
    scales = torch.rand((4, 200), generator=gen, device=cuda) * 1e-2
    x = torch.randn((tokens, 2048), generator=gen, device=cuda)
    before = w8_matmul.launches
    got = w8_matmul(x, wq, scales)
    want = w8_matmul_reference(x, wq, scales)
    torch.cuda.synchronize()
    assert w8_matmul.launches == before + 1
    torch.testing.assert_close(
        got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item()
    )


def _lowbit_case(kernel, gen, device, out_f=200, in_p=2048):
    def codes(n):
        return torch.randint(-128, 128, (out_f, n), generator=gen,
                             device=device, dtype=torch.int8)

    def scales(*shape):
        return (torch.rand(shape, generator=gen, device=device) * 1e-2).to(
            torch.bfloat16)

    if kernel == "w4":
        return w4_matmul, w4_matmul_reference, (
            codes(in_p // 2), scales(in_p // 128, out_f))
    if kernel == "w3":
        return w3_matmul, w3_matmul_reference, (
            codes(in_p // 4), codes(in_p // 8), scales(out_f, in_p // 128))
    group = int(kernel[len("w2g"):])
    return w2_matmul, w2_matmul_reference, (
        codes(in_p // 4), scales(out_f, in_p // group))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [1, 3, 16, 17, 40])
@pytest.mark.parametrize("kernel", ["w4", "w2g64", "w2g128", "w3"])
def test_lowbit_kernel_matches_plain_version(cuda, kernel, tokens, out_dtype):
    gen = torch.Generator(device=cuda).manual_seed(tokens)
    fn, ref, weights = _lowbit_case(kernel, gen, cuda)
    x = torch.randn((tokens, 2048), generator=gen, device=cuda)
    before = fn.launches
    got = fn(x, *weights, out_dtype=out_dtype)
    want = ref(x, *weights, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.shape == (tokens, 200) and got.dtype == out_dtype
    # both sum exact products in f32 per group: in f32 only the summation
    # order differs; in bf16, one ulp of the final rounding
    rtol = 1e-5 if out_dtype == torch.float32 else 1e-2
    torch.testing.assert_close(
        got.float(), want.float(), rtol=rtol,
        atol=rtol * want.float().abs().max().item(),
    )


def _stacked_case(fmt, gen, device, n_experts=5, out_f=200, in_p=2048):
    """Stacked experts of random codes with an odd number of rows."""
    if fmt == "int8":
        wq = torch.randint(-127, 128, (n_experts, out_f, in_p), generator=gen,
                           device=device, dtype=torch.int8)
        scales = torch.rand((n_experts, in_p // 512, out_f), generator=gen,
                            device=device) * 1e-2
        return (w8_matmul_expert, w8_matmul_expert_reference,
                w8_matmul_pairs, w8_matmul_pairs_reference, wq, scales)
    wq = torch.randint(-128, 128, (n_experts, out_f, in_p // 2),
                       generator=gen, device=device, dtype=torch.int8)
    scales = (torch.rand((n_experts, in_p // 128, out_f), generator=gen,
                         device=device) * 1e-2).to(torch.bfloat16)
    return (w4_matmul_expert, w4_matmul_expert_reference,
            w4_matmul_pairs, w4_matmul_pairs_reference, wq, scales)


def _assert_kernel_close(got, want, out_dtype):
    # both sum exact products in f32 per group: in f32 only the summation
    # order differs; in bf16, one ulp of the final rounding
    rtol = 1e-5 if out_dtype == torch.float32 else 1e-2
    torch.testing.assert_close(
        got.float(), want.float(), rtol=rtol,
        atol=rtol * want.float().abs().max().item(),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [1, 3, 16, 17, 40, 130])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_expert_kernel_matches_plain_version(cuda, fmt, tokens, out_dtype):
    """K6a / K6b on every expert of a stack, the last included, with the
    id on the card; an id outside the stack is clamped into it."""
    gen = torch.Generator(device=cuda).manual_seed(tokens)
    fn, ref, _, _, wq, scales = _stacked_case(fmt, gen, cuda)
    x = torch.randn((tokens, 2048), generator=gen, device=cuda)
    ids = torch.arange(5, dtype=torch.int32, device=cuda)
    before = fn.launches
    for e in range(5):
        got = fn(x, wq, scales, ids[e], out_dtype=out_dtype)
        want = ref(x, wq, scales, ids[e], out_dtype=out_dtype)
        assert got.shape == (tokens, 200) and got.dtype == out_dtype
        _assert_kernel_close(got, want, out_dtype)
    torch.cuda.synchronize()
    assert fn.launches == before + 5
    beyond = fn(x, wq, scales, torch.tensor(9, device=cuda),
                out_dtype=out_dtype)
    assert torch.equal(beyond, fn(x, wq, scales, ids[4], out_dtype=out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ids", [
    [4], [0, 4], [2, 2, 2, 2], [0, 1, 2, 3, 4], [4, 0, 3, 3, 1, 4, 0, 2] * 4,
    list(range(5)) * 26,
])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_pairs_kernel_matches_plain_version(cuda, fmt, ids, out_dtype):
    """K5a / K5b: one pair, repeated ids, all-distinct ids, the last
    expert, and more pairs (130) than a decode step of 64 tokens makes."""
    gen = torch.Generator(device=cuda).manual_seed(len(ids))
    _, _, fn, ref, wq, scales = _stacked_case(fmt, gen, cuda)
    x = torch.randn((len(ids), 2048), generator=gen, device=cuda)
    experts = torch.tensor(ids, device=cuda)
    before = fn.launches
    got = fn(x, wq, scales, experts, out_dtype=out_dtype)
    want = ref(x, wq, scales, experts, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.shape == (len(ids), 200) and got.dtype == out_dtype
    _assert_kernel_close(got, want, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_moe_kernels_run_on_the_current_stream(cuda, fmt):
    gen = torch.Generator(device=cuda).manual_seed(0)
    e_fn, e_ref, p_fn, p_ref, wq, scales = _stacked_case(fmt, gen, cuda)
    x = torch.randn((4, 2048), generator=gen, device=cuda)
    experts = torch.tensor([1, 4, 4, 0], device=cuda)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        got_e = e_fn(x, wq, scales, experts[1])
        got_p = p_fn(x, wq, scales, experts)
    stream.synchronize()
    _assert_kernel_close(got_e, e_ref(x, wq, scales, experts[1]),
                         torch.float32)
    _assert_kernel_close(got_p, p_ref(x, wq, scales, experts), torch.float32)


@pytest.mark.cuda
def test_moe_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    e_fn, _, p_fn, _, wq, scales = _stacked_case("int8", gen, cuda)
    x = torch.randn((2, 2048), generator=gen, device=cuda)
    with pytest.raises(ValueError, match="one device"):
        e_fn(x, wq, scales, torch.tensor(0))
    with pytest.raises(ValueError, match="one device"):
        p_fn(x, wq.cpu(), scales, torch.tensor([0, 1], device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        e_fn(x, wq.transpose(1, 2).contiguous().transpose(1, 2), scales,
             torch.tensor(0, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_mixtral_decode_reads_nothing_back(cuda, tmp_path, fmt):
    """A Mixtral decode step on the card: launch counts of the three
    kernels, and no synchronizing call (the expert ids stay on the card)."""
    from vptq_tpu_torch.models.llama import forward, init_cache
    from vptq_tpu_torch.models.loader import load_model

    write_synthetic_checkpoint(
        tmp_path,
        tiny_model_config(**TINY, tie_word_embeddings=False,
                          model_type="mixtral", num_local_experts=4,
                          num_experts_per_tok=2),
        vq_kwargs=VQ, seed=0,
    )
    model = load_model(str(tmp_path), runtime_format=fmt, device=cuda)
    cache = init_cache(model.cfg, 1, 256, torch.bfloat16, cuda)
    dense, (expert, pairs) = (
        chip_smoke.kernel_fns(chip_smoke.FORMAT_KERNEL[fmt])[0],
        [chip_smoke.kernel_fns(k)[0] for k in chip_smoke.MOE_KERNELS[fmt]],
    )
    prompt = torch.arange(70, device=cuda)[None]
    tok = torch.ones((1, 1), dtype=torch.int64, device=cuda)
    with torch.inference_mode():
        forward(model, prompt, cache, fresh_prefill=True)  # builds, warms up
        forward(model, tok, cache)
        torch.cuda.synchronize()
        counts = [f.launches for f in (dense, expert, pairs)]
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, _ = forward(model, tok, cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        forward(model, prompt, cache)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all())
    layers, experts = 2, 4
    assert [f.launches - n for f, n in zip((dense, expert, pairs), counts)] == [
        2 * layers * 2, 2 * experts * layers, 2 * layers]


def _flash_case(gen, device, batch, seq, heads, kv_heads, dim, factor=1.0):
    """q, k contiguous and v a view into a fused q|k|v row, in bf16."""
    widths = [heads * dim, kv_heads * dim, kv_heads * dim]
    qkv = torch.randn((batch, seq, sum(widths)), generator=gen, device=device)
    q, k, v = torch.split(qkv.to(torch.bfloat16), widths, dim=-1)
    q = (q * factor).reshape(batch, seq, heads, dim).contiguous()
    k = (k * factor).reshape(batch, seq, kv_heads, dim).contiguous()
    return q, k, v.reshape(batch, seq, kv_heads, dim)


def _assert_flash_close(got, want):
    # both round p to bf16 before p.v and the result to bf16 once; they
    # differ in summation order and exp2 against exp: one to two bf16 ulps
    # at the largest magnitude
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got.float()).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("dim", [64, 128])
@pytest.mark.parametrize("seq", [1, 63, 64, 65, 1024, 1100])
def test_flash_kernel_matches_plain_version(cuda, seq, dim, batch):
    gen = torch.Generator(device=cuda).manual_seed(seq + dim)
    q, k, v = _flash_case(gen, cuda, batch, seq, 8, 2, dim)
    assert seq == 1 or v.stride(1) == 12 * dim
    before = flash_attention.launches
    got = flash_attention(q, k, v, dim ** -0.5)
    want = flash_attention_reference(q, k, v, dim ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == (batch, seq, 8 * dim)
    _assert_flash_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 1), (6, 2)])
def test_flash_kernel_groups_strides_and_big_scores(cuda, heads, kv_heads):
    """MHA, MQA and GQA; every input a strided view; scores to about
    +-50; garbage past the prompt stays out of the real rows."""
    gen = torch.Generator(device=cuda).manual_seed(heads)
    dim, seq = 64, 200
    q, k, v = _flash_case(gen, cuda, 2, seq, heads, kv_heads, dim, 12 ** 0.5)
    wide = torch.zeros((2, seq, heads + 1, dim), dtype=torch.bfloat16,
                       device=cuda)
    q_view = wide[:, :, 1:]
    q_view.copy_(q)
    got = flash_attention(q_view, k, v, dim ** -0.5)
    want = flash_attention_reference(q, k, v, dim ** -0.5)
    _assert_flash_close(got, want)
    for t in (q, k, v):
        t[:, 150:] = 3e4
    padded = flash_attention(q, k, v, dim ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(padded[:, :150], got[:, :150])
    assert bool(torch.isfinite(padded.float()).all())


@pytest.mark.cuda
def test_flash_kernel_runs_on_the_current_stream_and_refuses(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = _flash_case(gen, cuda, 1, 300, 4, 2, 64)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        got = flash_attention(q, k, v, 0.125)
    stream.synchronize()
    _assert_flash_close(got, flash_attention_reference(q, k, v, 0.125))
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q.float(), k.float(), v.float(), 0.125)
    with pytest.raises(ValueError, match=r"supported sizes are \(64, 128\)"):
        flash_attention(q[..., :32], k[..., :32], v[..., :32], 0.125)
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, k.cpu(), v, 0.125)
    with pytest.raises(ValueError, match="contiguously"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                        0.125)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [1, 3, 16, 17, 40, 130])
def test_bf16_kernel_matches_plain_version(cuda, tokens, out_dtype):
    gen = torch.Generator(device=cuda).manual_seed(tokens)
    w = (torch.randn((201, 1536), generator=gen, device=cuda) * 0.05).to(
        torch.bfloat16)
    x = torch.randn((tokens, 1536), generator=gen, device=cuda)
    before = bf16_matmul.launches
    got = bf16_matmul(x, w, out_dtype=out_dtype)
    want = bf16_matmul_reference(x, w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert bf16_matmul.launches == before + 1
    assert got.shape == (tokens, 201) and got.dtype == out_dtype
    _assert_kernel_close(got, want, out_dtype)
    with pytest.raises(ValueError, match="% 512"):
        bf16_matmul(x[:, :768], w[:, :768].contiguous())


@pytest.mark.cuda
def test_long_fresh_prefill_goes_through_k8(cuda, checkpoint):
    """A 1024-token fresh prefill on the card: K8 once per layer, logits
    as through the plain versions; a chunk at an offset and a windowed
    model stay out of K8."""
    from vptq_tpu_torch.models.llama import forward, init_cache
    from vptq_tpu_torch.models.loader import load_model

    # head_dim 64: TINY's 16 is a size the kernel is not built for
    path = Path(checkpoint) / "wide"
    write_synthetic_checkpoint(
        path, tiny_model_config(**{**TINY, "hidden_size": 256, "head_dim": 64},
                                tie_word_embeddings=False),
        vq_kwargs=VQ, seed=0, std=0.05,
    )
    model = load_model(str(path), runtime_format="int8", device=cuda)
    tokens = torch.arange(1024, device=cuda)[None] % TINY["vocab_size"]

    def run():
        cache = init_cache(model.cfg, 1, 2048, torch.bfloat16, cuda)
        with torch.inference_mode():
            logits, _ = forward(model, tokens, cache, fresh_prefill=True)
            forward(model, tokens, cache)  # at offset 1024
        torch.cuda.synchronize()
        return logits

    before = flash_attention.launches
    got = run()
    assert flash_attention.launches == before + TINY["num_hidden_layers"]
    with chip_smoke.plain_versions("int8"):
        want = run()
    assert flash_attention.launches == before + TINY["num_hidden_layers"]
    diff = (got - want).abs().max().item()
    assert diff <= chip_smoke.LOGIT_TOL * want.abs().max().item()

    tiny = load_model(checkpoint, runtime_format="int8", device=cuda)
    cache = init_cache(tiny.cfg, 1, 2048, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="supported sizes"):
        forward(tiny, tokens, cache, fresh_prefill=True)
