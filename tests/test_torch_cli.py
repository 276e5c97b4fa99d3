"""The port's CLI (``python -m vptq_tpu_torch``) against vptq_tpu's.

Every case of tests/test_cli.py on the port (``--device cpu``), with
``--tp`` refused instead of served; then one-shot and chat at
temperature 0 with stdout identical, byte for byte, to the JAX CLI's on
the same checkpoint and byte tokenizer (the JAX side runs the Pallas
kernels in interpret mode, as a TPU would, so that activations are
rounded to bf16 as the port's kernels round them; the port rounds its
bf16 SiLU as XLA's CPU lowering of ``jax.nn.silu`` does, see
``torch_port.xla_cpu_silu``, without which the first token of the int8
one-shot below parts); and one run of ``python -m vptq_tpu_torch`` in a
subprocess.
"""

import filecmp
import functools
import io
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_port import TINY, VQ, xla_cpu_silu

from vptq_tpu import native
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.models.llama import forward as j_forward
from vptq_tpu.models.llama import init_cache as j_init_cache
from vptq_tpu.serving import cli as jcli
from vptq_tpu.utils import synth_checkpoint as jsc
from vptq_tpu.utils.synth_tokenizer import (
    write_byte_tokenizer as j_write_byte_tokenizer,
)
from vptq_tpu_torch.models.llama import forward, init_cache
from vptq_tpu_torch.models.loader import load_model
from vptq_tpu_torch.serving import cli
from vptq_tpu_torch.utils.synth_tokenizer import write_byte_tokenizer

ROOT = Path(__file__).resolve().parent.parent
# ids from 259 on decode to nothing: few of them, so that the text shows
# the tokens
CFG = dict(TINY, vocab_size=272, tie_word_embeddings=False)
GREEDY = ["--max-new-tokens", "6", "--max-seq", "64", "--temperature", "0"]


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli_ckpt")
    jsc.write_synthetic_checkpoint(
        str(d), jsc.tiny_model_config(**CFG), vq_kwargs=VQ, seed=3
    )
    write_byte_tokenizer(str(d), vocab_size=272)
    return str(d)


@pytest.fixture(scope="module")
def jax_pallas():
    """vptq_tpu's kernels as on a TPU: Pallas in interpret mode, and the
    numpy encoders (its C++ host library divides otherwise); set for the
    whole module, so that JAX compiles each op once."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_lib", lambda: None)
        mp.setattr(sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL",
                   "pallas")
        mp.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
        yield
    # jit caches are keyed on shapes, not on the switch: a trace made
    # here would serve a later test at the same shapes on the XLA path
    jax.clear_caches()


@pytest.fixture
def jax_text(jax_pallas, monkeypatch):
    """Both packages on the same bf16 arithmetic, every op rounded to
    bf16: the JAX side op by op (``jax.disable_jit``: XLA's fusion of a
    jitted forward keeps some bf16 intermediates in f32, and its tokens
    part from its own op-by-op run's on a near tie, see
    ``test_bf16_logits_part_only_at_the_silu``), the port's SiLU rounded
    as XLA's CPU lowering of ``jax.nn.silu`` rounds it."""
    monkeypatch.setattr(F, "silu", xla_cpu_silu)
    with jax.disable_jit():
        yield


def _port(argv):
    return cli.main([*argv, "--device", "cpu"])


def test_cli_one_shot_prompt(ckpt_dir, capsys):
    rc = _port(["--model", ckpt_dir, "--prompt", "hi", *GREEDY])
    assert rc == 0
    out = capsys.readouterr().out
    # the prompt is echoed first, then the streamed completion
    assert out.startswith("hi")
    assert out.endswith("\n")


def test_cli_chat_mode(ckpt_dir, capsys, monkeypatch):
    monkeypatch.setattr("sys.stdin", io.StringIO("hello\nclear\n\nexit\n"))
    rc = _port([
        "--model", ckpt_dir, "--chat", "--chat-system-prompt", "be brief",
        *GREEDY,
    ])
    assert rc == 0
    assert "Assistant: " in capsys.readouterr().out


def test_cli_requires_prompt_or_chat(capsys):
    assert cli.main(["--model", "/nonexistent"]) == 2


def test_cli_rejects_unknown_runtime_format(ckpt_dir):
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(
            ["--model", ckpt_dir, "--runtime-format", "fp8"]
        )


@pytest.mark.parametrize("fmt", ["int8", "codebook"])
def test_cli_tp_is_refused(ckpt_dir, fmt):
    """``--tp 2`` serves sharded in vptq_tpu; the port runs on one device
    and refuses it, naming the milestone that would bring it."""
    with pytest.raises(SystemExit, match="M16"):
        _port([
            "--model", ckpt_dir, "--prompt", "hi", "--runtime-format", fmt,
            "--tp", "2",
        ])


def test_byte_tokenizer_directory_equals_jax(tmp_path):
    write_byte_tokenizer(str(tmp_path / "port"), vocab_size=300)
    j_write_byte_tokenizer(str(tmp_path / "jax"), vocab_size=300)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "jax", tmp_path / "port", names, shallow=False)
    assert mismatch == [] and errors == []
    with pytest.raises(ValueError):
        write_byte_tokenizer(str(tmp_path / "small"), vocab_size=258)


def _bf16_logits(ckpt_dir, fmt, prompt, jit=False):
    jmodel = j_load_model(ckpt_dir, dtype=jnp.bfloat16, runtime_format=fmt)
    tmodel = load_model(ckpt_dir, dtype=torch.bfloat16, runtime_format=fmt,
                        device="cpu")
    tokens = np.zeros((1, 64), np.int64)
    tokens[0, : len(prompt)] = prompt
    j_fwd = functools.partial(j_forward, dtype=jnp.bfloat16,
                              fresh_prefill=True)
    want, _ = (jax.jit(j_fwd) if jit else j_fwd)(
        jmodel, jnp.asarray(tokens, jnp.int32),
        j_init_cache(jmodel.cfg, 1, 64, jnp.bfloat16))
    with torch.inference_mode():
        got, _ = forward(
            tmodel, torch.from_numpy(tokens),
            init_cache(tmodel.cfg, 1, 64, torch.bfloat16, "cpu"),
            dtype=torch.bfloat16, fresh_prefill=True)
    n = len(prompt)
    return got[0, :n].numpy(), np.asarray(want, np.float32)[0, :n]


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_bf16_logits_part_only_at_the_silu(ckpt_dir, jax_pallas,
                                           monkeypatch, fmt):
    """The trace behind ``jax_text``. In bf16 the port's logits differ from
    vptq_tpu's op-by-op forward's only through the SiLU: with it rounded
    as XLA's CPU lowering rounds it they are the same bits. vptq_tpu's
    jitted forward (its Generator's) differs from its own op-by-op one;
    all three lie within the smoke's LOGIT_TOL (5e-2 of max) of each
    other, and on "The quick brown fox" in int8 the jitted forward's
    greedy token is another than the op-by-op one's."""
    prompt = [3 + b for b in b"The quick brown fox"]
    got, want = _bf16_logits(ckpt_dir, fmt, prompt)
    _, jitted = _bf16_logits(ckpt_dir, fmt, prompt, jit=True)
    assert not np.array_equal(got, want)
    assert not np.array_equal(jitted, want)
    scale = np.abs(want).max()
    for other in (got, jitted):
        assert np.abs(other - want).max() <= 5e-2 * scale
    if fmt == "int8":
        assert jitted[-1].argmax() != want[-1].argmax()
    monkeypatch.setattr(F, "silu", xla_cpu_silu)
    got, want = _bf16_logits(ckpt_dir, fmt, prompt)
    np.testing.assert_array_equal(got, want)


def test_one_shot_stdout_equals_jax(ckpt_dir, capsys, jax_text):
    argv = ["--model", ckpt_dir, "--prompt", "The quick brown fox", *GREEDY]
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert _port(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    assert len(got) > len("The quick brown fox\n")


def test_chat_stdout_equals_jax(ckpt_dir, capsys, monkeypatch, jax_text):
    """A turn with a system prompt, ``clear`` (the system prompt stays), an
    empty line, a second turn and ``exit``, with a prefix cache on."""
    lines = "hello there\nclear\n\nsecond\nexit\nnever read\n"
    argv = ["--model", ckpt_dir, "--chat", "--chat-system-prompt",
            "be brief", "--prefix-cache-mb", "1", *GREEDY]
    monkeypatch.setattr("sys.stdin", io.StringIO(lines))
    assert jcli.main(argv) == 0
    want = capsys.readouterr()
    monkeypatch.setattr("sys.stdin", io.StringIO(lines))
    assert _port(argv) == 0
    got = capsys.readouterr()
    assert got.out == want.out and got.err == want.err
    assert got.out.count("Assistant: ") == 2


def test_python_m_vptq_tpu_torch(ckpt_dir, capsys):
    """``python -m vptq_tpu_torch`` as a user runs it, in a process of its
    own: the same stdout as the in-process CLI."""
    argv = ["--model", ckpt_dir, "--prompt", "hi", *GREEDY]
    assert _port(argv) == 0
    want = capsys.readouterr().out
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    got = subprocess.run(
        [sys.executable, "-m", "vptq_tpu_torch", *argv, "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert got.returncode == 0, got.stderr
    assert got.stdout == want
