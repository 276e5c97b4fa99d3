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
from vptq_tpu_torch.ops.w2_matmul import w2_matmul, w2_matmul_reference
from vptq_tpu_torch.ops.w3_matmul import w3_matmul, w3_matmul_reference
from vptq_tpu_torch.ops.w4_matmul import w4_matmul, w4_matmul_reference
from vptq_tpu_torch.ops.w8_matmul import w8_matmul, w8_matmul_reference
from vptq_tpu_torch.utils.synth_checkpoint import (
    tiny_model_config,
    write_synthetic_checkpoint,
)

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import vptq_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vptq_tpu_torch.__path__, "vptq_tpu_torch.")]
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
    assert int(out[0]) >= 25  # every module of the package was imported
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
    records = chip_smoke.kernel_records(rows, dict.fromkeys(kernels, 0),
                                        tokens=(1, 20))
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert len(records) == 8 and all(keys <= set(r) for r in records)
    assert all((ROOT / r["source"]).exists() for r in records)
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
            assert e2e["launches"] == 0  # the CPU runs the plain versions
            assert e2e["logits_max_abs_diff"] == 0.0
    finally:
        shutil.rmtree(path, ignore_errors=True)


def test_k1_shapes_of_llama31_8b():
    assert chip_smoke.k1_shapes(chip_smoke.LLAMA31_8B) == [
        ("qkv", 6144, 4096), ("o", 4096, 4096),
        ("gate_up", 28672, 4096), ("down", 4096, 14336),
    ]


@pytest.mark.parametrize("name", sorted(chip_smoke.FORMAT_KERNEL.values()))
def test_kernel_names_its_tpu_kernel_and_trace_tags(name):
    """A wrapper's ``replaces`` points at the Pallas kernel body it ports,
    and its ``trace_tags`` occur in its CUDA sources."""
    fn, _ = chip_smoke.kernel_fns(name)
    path, line = fn.replaces.split(":")
    body = (ROOT / path).read_text().splitlines()[int(line) - 1]
    assert body.startswith(f"def _{name.split('_')[0]}_kernel("), body
    src = (ROOT / "vptq_tpu_torch/csrc" / f"{name}.cu").read_text()
    if "lowbit.cuh" in src:
        src += (ROOT / "vptq_tpu_torch/csrc/lowbit.cuh").read_text()
    assert all(tag in src for tag in fn.trace_tags)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1-K4 are CUDA kernels")
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


@pytest.mark.cuda
def test_long_fresh_prefill_waits_for_k8(cuda, checkpoint):
    from vptq_tpu_torch.models.llama import forward, init_cache
    from vptq_tpu_torch.models.loader import load_model

    model = load_model(checkpoint, runtime_format="int8", device=cuda)
    cache = init_cache(model.cfg, 1, 2048, torch.bfloat16, cuda)
    with pytest.raises(NotImplementedError, match="K8"):
        forward(model, torch.zeros((1, 1024), dtype=torch.int64, device=cuda),
                cache, fresh_prefill=True)
