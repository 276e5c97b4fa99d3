"""vptq_tpu_torch stands alone, picks its device, and chip_smoke.py's
phases run at a tiny size on the CPU with the plain versions.

Tests marked ``cuda`` need an NVIDIA GPU; they skip elsewhere. This file
imports no JAX, so a machine with a GPU and no JAX runs them with
``python -m pytest --noconftest tests/test_torch_isolation.py -m cuda``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_port import LLAMA3_SCALING, TINY, VQ

import chip_smoke
from vptq_tpu_torch import AutoModelForCausalLM
from vptq_tpu_torch.convert import convert_params
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
    assert int(out[0]) >= 15  # every module of the package was imported
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
    rows = chip_smoke.phase_k1("cpu", shapes, tokens=(1, 20), iters=1)
    assert len(rows) == 4 and all(r["max_abs_err"] == 0.0 for r in rows)
    records = chip_smoke.kernel_records(rows, 0)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(r) for r in records)
    json.dumps(records)

    cfg = dict(TINY, tie_word_embeddings=False,
               rope_scaling=tuple(sorted(LLAMA3_SCALING.items())))
    e2e = chip_smoke.phase_e2e(
        "cpu", cfg, VQ, prompt_lens=(5, 20, 40), new_tokens=4, max_seq=64
    )
    assert [r["prompt"] for r in e2e["requests"]] == [5, 20, 40]
    assert e2e["logits_max_abs_diff"] == 0.0


def test_k1_shapes_of_llama31_8b():
    assert chip_smoke.k1_shapes(chip_smoke.LLAMA31_8B) == [
        ("qkv", 6144, 4096), ("o", 4096, 4096),
        ("gate_up", 28672, 4096), ("down", 4096, 14336),
    ]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 is a CUDA kernel")
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


@pytest.mark.cuda
def test_long_fresh_prefill_waits_for_k8(cuda, checkpoint):
    from vptq_tpu_torch.models.llama import forward, init_cache
    from vptq_tpu_torch.models.loader import load_model

    model = load_model(checkpoint, runtime_format="int8", device=cuda)
    cache = init_cache(model.cfg, 1, 2048, torch.bfloat16, cuda)
    with pytest.raises(NotImplementedError, match="K8"):
        forward(model, torch.zeros((1, 1024), dtype=torch.int64, device=cuda),
                cache, fresh_prefill=True)
