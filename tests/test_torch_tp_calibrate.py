"""vptq_tpu_torch's calibration under tensor parallelism against vptq_tpu's,
and the interactive entry points under ``--tp``.

* The blocked GPTQ (``_gptq_layer_blocked``), ``_select_cols(shards)``
  and ``_gptq_layer_mixed(shards)`` on the same weights and correlated
  Hessians as vptq_tpu's, at 2 and 4 shards, in int8, int4, int3 and
  int2: the same arrays and columns, the codes and the error ratio within
  ``test_torch_gptq``'s stated bounds; their padded widths are the
  blocked RTN encoders'.
* The propagation: block 0 of ``quantize_model_calibrated(tp_shards=2)``
  JAX's (its codes but for the stated share of ``test_torch_calibrate``);
  each later block's sites JAX's ``_quantize_site(row_shards=2)`` fed the
  port's own Hessian (within the stated GPTQ bounds); a blocked
  layer run shard by shard (``tp.ShardSum``) is the numpy sum over
  shards of ``x_s @ w_hat_s.T``; and JAX's block-1 Hessian is not the
  one its placed model would give (its blocked layers run as if they
  were one-device layers, ``vptq_tpu/quant/calibrate.py:1016-1020``:
  the defect the port does not copy, ROADMAP Queue 3).
* Under 2 gloo ranks (one spawn for the file, ``torch_port
  .tp_rank_calibrated``, started before the first test): in int2-,
  int3- and int4-mixed each rank's shard of the calibrated load
  byte-equal to placing the one-device blocked calibration, by the
  port's placement and by vptq_tpu's; its ``forward_tp`` logits within
  1e-4 of max of the shard-by-shard one-device model's (and, in one
  format, of vptq_tpu's ``forward_tp``) and the greedy tokens equal;
  chat and the web app (a model switch, a refused prompt and a streaming
  client that goes away too) under ``--tp 2`` give the one-device
  output.
* Resume of a blocked run, and the refusals that stay: a resume at
  another shard count; a blocked model written as a runtime file.

The JAX side runs its Pallas kernels in interpret mode and its numpy
encoders (``tests/test_torch_calibrate.py``'s fixture).
"""

import copy
import functools
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_calibrate import CODE_SHARE
from test_torch_calibrate import _codes as cal_codes
from test_torch_gptq import CORRELATED_BOUND
from test_torch_tp import _shards, _state_bytes
from torch_port import TINY, VQ, join_ranks, start_ranks, tp_rank_calibrated

from vptq_tpu import native
from vptq_tpu.models import load_model as j_load_model
from vptq_tpu.models.llama import init_cache as j_init_cache
from vptq_tpu.parallel import tp as jtp
from vptq_tpu.parallel.sharding import make_mesh as j_make_mesh
from vptq_tpu.quant import calibrate as jcal
from vptq_tpu.tools import export_runtime as jexport
from vptq_tpu_torch.convert import convert_shard
from vptq_tpu_torch.layers import runtime as trt
from vptq_tpu_torch.models.llama import forward, init_cache
from vptq_tpu_torch.models.loader import (
    _calibrated_lm_head,
    load_model,
    write_safetensors,
)
from vptq_tpu_torch.ops import packing as tpk
from vptq_tpu_torch.parallel import tp
from vptq_tpu_torch.parallel.mesh import Mesh
from vptq_tpu_torch.quant import calibrate as tcal
from vptq_tpu_torch.quant import gptq as tg
from vptq_tpu_torch.serving import cli
from vptq_tpu_torch.serving.generate import Generator
from vptq_tpu_torch.tools import export_runtime as texport
from vptq_tpu_torch.utils import synth_checkpoint as tsc
from vptq_tpu_torch.utils.synth_tokenizer import write_byte_tokenizer

STD = 0.05  # tests/test_torch_calibrate.py's spread
CALIBRATION = 128
# the byte tokenizer's ids from 259 on decode to nothing
CFG = dict(TINY, vocab_size=272, tie_word_embeddings=False)
WORLD = 2
GREEDY = ["--max-new-tokens", "6", "--max-seq", "64", "--temperature", "0"]
CHAT = ["hello", "clear", "what now?", "exit"]


@pytest.fixture(scope="module", autouse=True)
def jax_pallas():
    """vptq_tpu's Pallas kernels in interpret mode and its numpy encoders
    for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_lib", lambda: None)
        mp.setattr(sys.modules["vptq_tpu.ops.quant_matmul"], "_IMPL", "pallas")
        mp.setenv("VPTQ_TPU_PALLAS_INTERPRET", "1")
        yield
        jax.clear_caches()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp_calibrate") / "ckpt"
    tsc.write_synthetic_checkpoint(
        str(path), tsc.tiny_model_config(**CFG), vq_kwargs=VQ, seed=6,
        std=STD)
    write_byte_tokenizer(str(path), vocab_size=CFG["vocab_size"])
    return str(path)


@functools.lru_cache(maxsize=None)
def _exact(path: str):
    return (
        j_load_model(path, dtype=jnp.float32, runtime_format="codebook",
                     fuse=False),
        load_model(path, dtype=torch.float32, runtime_format="codebook",
                   fuse=False, device="cpu"),
    )


def _tokens(path: str):
    return tcal.synthetic_calibration_tokens(CFG["vocab_size"], CALIBRATION)


# ------------------------------------------------ the blocked encoders


def _wh(seed, out_f, in_f):
    """A weight and a correlated Hessian (x of 300 rows)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((out_f, in_f)) * 0.05).astype(np.float32)
    x = rng.standard_normal((300, in_f)).astype(np.float32)
    x[:, 1:] += 0.5 * x[:, :-1]
    return w, (x.T @ x).astype(np.float32)


def _leaves(layer) -> dict:
    """{name: numpy array} of a vptq_tpu layer (bf16 viewed as f32)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(layer)[0]:
        name = ".".join(str(getattr(k, "name", k)) for k in path)
        out[name] = np.asarray(leaf.astype(jnp.float32)
                               if leaf.dtype == jnp.bfloat16 else leaf)
    return out


def _codes(layer, arrays: dict, prefix: str = ""):
    """The unpacked codes of a port ``layer`` whose arrays (by name, the
    port's and JAX's alike) are ``arrays``."""
    get = lambda name: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        arrays[prefix + name]))
    if isinstance(layer, trt.Int4Linear):
        return tpk.unpack_int4(get("wq"))
    if isinstance(layer, trt.Int3Linear):
        return tpk.unpack_int3(get("wq2"), get("wq1"))
    if isinstance(layer, trt.Int2Linear):
        return tpk.unpack_int2(get("wq"))
    return get("wq")


def _same_layer(jlayer, tlayer, bits=None) -> None:
    """JAX's layer and the port's: the same arrays, names, shapes and
    dtypes; byte for byte when ``bits`` is None, else (GPTQ under a
    correlated Hessian) the codes within ``test_torch_gptq``'s stated
    bound for ``bits`` (share and levels; int8 sides by its int8 bound);
    the scales then follow, and :func:`_same_error` holds the result."""
    want = _leaves(jlayer)
    got = {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
           for k, v in tlayer.state_dict().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].astype(got[k].dtype).dtype, k
        if bits is None:
            assert np.array_equal(got[k], want[k].astype(got[k].dtype)), k
    if bits is None:
        return
    parts = [("", tlayer, bits)]
    if isinstance(tlayer, trt._MixedLinear):
        parts = [(tlayer._BASE + ".", tlayer.base, bits),
                 ("int8.", tlayer.int8, 8)]
        assert np.array_equal(got["col_idx"], want["col_idx"])
    for prefix, layer, b in parts:
        share, levels = CORRELATED_BOUND[b]
        diff = (_codes(layer, got, prefix).to(torch.int16)
                - _codes(layer, want, prefix).to(torch.int16)).abs()
        assert (diff > 0).float().mean() <= share, (prefix, diff)
        assert diff.max() <= levels


def _same_error(w, h, jhat, that) -> None:
    """The H-weighted output error ratio of the port's ``w_hat`` within 1%
    of JAX's (``test_torch_gptq``'s stated bound)."""
    wt, ht = torch.from_numpy(w), torch.from_numpy(h.astype(np.float64))
    e_jax = tg.output_error_ratio(wt, torch.from_numpy(np.asarray(jhat)), ht)
    e_port = tg.output_error_ratio(wt, that, ht)
    assert abs(e_port - e_jax) <= 1e-2 * e_jax, (e_port, e_jax)


@pytest.mark.parametrize("bits,shards", [(8, 2), (4, 2), (3, 2), (2, 2),
                                         (8, 4), (4, 4)])
def test_blocked_gptq_is_jax(bits, shards):
    """``_gptq_layer_blocked`` on JAX's w and correlated H: JAX's layer,
    its codes and error ratio within the stated GPTQ bounds (without a
    Hessian byte for byte), at widths that split evenly, that pad the
    whole weight, and that pad every shard. Its shapes are the blocked
    RTN encoder's, which ``tp._row_parallel`` already slices. (Four
    shards run the same loop as two; int3 and int2 would pad each of
    them to 1024 columns.)"""
    # every int3 / int2 shard pads to 1024 columns: one width there
    for seed, in_f in enumerate((201,) if bits in (2, 3) else (256, 201)):
        w, h = _wh(seed, 16, in_f)
        jlayer, jhat = jcal._gptq_layer_blocked(bits, w, None, h, 0.01,
                                                shards)
        tlayer, that = tcal._gptq_layer_blocked(
            bits, torch.from_numpy(w), None, torch.from_numpy(h), 0.01,
            shards)
        _same_layer(jlayer, tlayer, bits)
        _same_error(w, h, jhat, that)
        assert tlayer.shards == shards
        # without a Hessian (RTN on the grid-searched scales): byte for byte
        _same_layer(jcal._gptq_layer_blocked(bits, w, None, None, 0.01,
                                             shards)[0],
                    tcal._gptq_layer_blocked(bits, torch.from_numpy(w), None,
                                             None, 0.01, shards)[0])
        rtn = {8: trt._encode_int8, 4: trt._encode_int4, 3: trt._encode_int3,
               2: trt._encode_int2}[bits](torch.from_numpy(w), None,
                                          shards=shards)
        assert {k: v.shape for k, v in rtn.state_dict().items()} == {
            k: v.shape for k, v in tlayer.state_dict().items()}


@pytest.mark.parametrize("base_bits,shards,in_f,seed",
                         [(3, 2, 512, 10), (2, 4, 256, 11)])
def test_mixed_blocked_is_jax(base_bits, shards, in_f, seed):
    """``_select_cols(shards)``: the same count in every shard, global ids
    shard by shard, JAX's; ``_gptq_layer_mixed(shards)``: the blocked
    planes, the side encoded shard by shard and shard-local ``col_idx``:
    JAX's layer, its codes and error ratio within the stated GPTQ bounds
    (at a width whose shards give 128 side columns each, and at a toy
    width whose 64-column shards give all of theirs)."""
    w, h = _wh(seed, 32, in_f)
    frac = 1 / 16
    jcols = jcal._select_cols([w], h, frac, shards=shards)
    tcols = tcal._select_cols([torch.from_numpy(w)], torch.from_numpy(h),
                              frac, shards=shards)
    assert np.array_equal(tcols.numpy(), jcols)
    jlayer, jhat = jcal._gptq_layer_mixed(base_bits, w, None, h, 0.01,
                                          jcols, shards=shards)
    tlayer, that = tcal._gptq_layer_mixed(
        base_bits, torch.from_numpy(w), None, torch.from_numpy(h), 0.01,
        tcols, shards=shards)
    _same_layer(jlayer, tlayer, base_bits)
    _same_error(w, h, jhat, that)
    k = len(jcols) // shards
    assert int(tlayer.col_idx.max()) < in_f // shards
    assert np.array_equal(
        tlayer.col_idx.numpy() + np.repeat(np.arange(shards), k)
        * (in_f // shards), jcols)
    with pytest.raises(ValueError, match="does not divide"):
        tcal._select_cols([torch.zeros(4, 250)], None, frac, shards=4)


def _dense_products(layer, shards, x):
    """numpy's sum over shards of ``x_s @ w_hat_s.T``: each shard's exact
    dequantized weight (its own padding cut) on its block of x."""
    total = None
    for s in range(shards):
        part = tp._row_parallel(layer, Mesh(data=1, model=shards, rank=s),
                                None, reencode=False)
        if isinstance(part, trt._MixedLinear):
            w = trt.linear_exact_weight(part.base).numpy().astype(np.float64)
            side = trt.linear_exact_weight(part.int8).numpy()[
                :, :part.col_idx.numel()]
            w[:, part.col_idx.numpy()] += side
        else:
            w = trt.linear_exact_weight(part).numpy().astype(np.float64)
        blk = w.shape[1]
        xs = np.zeros((x.shape[0], blk))
        cols = x[:, s * (x.shape[1] // shards):(s + 1) * (x.shape[1]
                                                          // shards)]
        xs[:, :cols.shape[1]] = cols
        y = xs @ w.T
        total = y if total is None else total + y
    return total


@pytest.mark.parametrize("fmt", ["int2-mixed", "int3-mixed", "int4", "int8"])
def test_shard_sum_is_the_sum_over_shards(fmt):
    """A blocked layer run on one device as TP computes it
    (``tp.ShardSum``) is the numpy sum over its shards of ``x_s @
    w_hat_s.T``, and equals ``x @ w_hat.T`` with the ``w_hat`` that
    GPTQ dequantized shard by shard (which no slicing of the layer made);
    the same layer run as if it were a one-device layer (JAX's
    propagation) is not. int8 is the blocked site that int4-mixed
    forces."""
    w, h = _wh(3, 48, 256)
    tw, th = torch.from_numpy(w), torch.from_numpy(h)
    bits = int(fmt[3])
    if fmt in ("int4", "int8"):
        layer, w_hat = tcal._gptq_layer_blocked(bits, tw, None, th, 0.01, 2)
    else:
        cols = tcal._select_cols([tw], th, 1 / 16, shards=2)
        layer, w_hat = tcal._gptq_layer_mixed(bits, tw, None, th, 0.01, cols,
                                              shards=2)
    # bf16-exact x: the kernels (here their plain versions) round x to
    # bf16, numpy would not
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (5, 256)).astype(np.float32)).to(torch.bfloat16).float().numpy()
    want = _dense_products(layer, 2, x.astype(np.float64))
    got = tp.ShardSum(layer)(torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(x.astype(np.float64) @ w_hat.numpy().T.astype(np.float64)
                  - want).max() <= 1e-5 * scale
    wrong = layer(torch.from_numpy(x)).numpy()
    assert np.abs(wrong - want).max() > 0.1 * scale
    # shards_summed replaces it in a tree and leaves the tree as it was
    mlp = torch.nn.Module()
    mlp.down_proj = layer
    summed = tp.shards_summed(mlp)
    assert isinstance(summed.down_proj, tp.ShardSum)
    assert mlp.down_proj is layer


# ------------------------------------------------ the propagation


def _spied(module, fmt, path, tp_shards):
    """(model, report, the arguments of each ``_quantize_site`` call, and
    whether each block forward ran a ``ShardSum``) of one calibration of
    ``module`` (jcal or tcal)."""
    jexact, texact = _exact(path)
    seen, forwards = [], []
    real, real_forward = module._quantize_site, module._block_forward

    def spy(members, hess, *args, **kw):
        seen.append((members, hess, args, kw))
        return real(members, hess, *args, **kw)

    def forward_spy(i, block, *args):
        forwards.append(any(isinstance(m, tp.ShardSum)
                            for m in block.modules()))
        return real_forward(i, block, *args)

    tokens = _tokens(path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "_quantize_site", spy)
        if module is tcal:
            mp.setattr(module, "_block_forward", forward_spy)
        if module is jcal:
            out = jcal.quantize_model_calibrated(
                jexact, tokens.numpy(), fmt, tp_shards=tp_shards,
                upload=False, site_workers=1)
        else:
            out = tcal.quantize_model_calibrated(texact, tokens, fmt,
                                                 tp_shards=tp_shards)
    return out[0], out[1], seen, forwards


@functools.lru_cache(maxsize=None)
def _both(path, fmt):
    return _spied(jcal, fmt, path, 2), _spied(tcal, fmt, path, 2)


def _hess(h):
    return None if h is None else np.asarray(h, np.float64)


def test_blocked_calibration_is_jax_where_it_should_be(ckpt):
    """int2-mixed over 2 shards. Block 0 of the port's blocked calibration
    is JAX's, from Hessians within f32 rounding of JAX's: the same arrays
    and columns, the codes but for ``test_torch_calibrate``'s stated share
    (GPTQ rounds in another order than numpy's and LAPACK's).
    Block 1's sites are JAX's ``_quantize_site(row_shards=2)`` fed the
    port's own Hessian, within the stated GPTQ bounds. And JAX's block-1
    Hessians are not the port's: its propagation ran the blocked o and
    down as one-device layers, where the port runs what the placed model
    computes."""
    (jmodel, jrep, jseen, _), (tmodel, trep, tseen, _) = _both(
        ckpt, "int2-mixed")
    assert len(jseen) == len(tseen)
    per_block = len(tseen) // CFG["num_hidden_layers"]
    assert {k: v["format"] for k, v in trep.items() if "format" in v} == {
        k: v["format"] for k, v in jrep.items() if "format" in v}
    gaps = [np.abs(_hess(jh) - _hess(th.numpy())).max()
            / np.abs(_hess(th.numpy())).max()
            for (_, jh, _, _), (_, th, _, _) in zip(jseen, tseen)]
    assert max(gaps[:per_block]) <= 1e-5, gaps
    assert min(gaps[per_block:]) > 1e-2, gaps
    want = {k: np.asarray(v) for k, v in jexport._flatten_model(
        jmodel).items() if k.startswith("blocks.0.")}
    got = {k: v for k, v in texport._flatten_model(tmodel).items()
           if k.startswith("blocks.0.")}
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        if k.endswith("mix_cols"):
            assert np.array_equal(v.numpy(), want[k]), k
    jc, tc = cal_codes(want), cal_codes(got)
    differ = sum(int((jc[k] != tc[k]).sum()) for k in jc)
    assert differ <= CODE_SHARE * sum(v.numel() for v in jc.values())
    for (jm, _, jargs, jkw), (tm, th, targs, tkw) in zip(
            jseen[per_block:], tseen[per_block:]):
        assert jkw["row_shards"] == tkw["row_shards"]
        jout, jsite = jcal._quantize_site(jm, th.numpy(), *jargs, **jkw)
        tout, tsite = tcal._quantize_site(tm, th, *targs, **tkw)
        assert jsite["format"] == tsite["format"]
        for (jp, jl), (tp_, tl) in zip(jout, tout):
            assert jp == tp_
            _same_layer(jl, tl, 2)


def test_propagation_runs_the_shard_sums(ckpt):
    """Every propagation forward of the port ran its blocked layers as
    ``ShardSum``s; a capture forward ran the exact mirrors."""
    forwards = _both(ckpt, "int2-mixed")[1][3]
    assert forwards == [False, True] * CFG["num_hidden_layers"]


def test_resume_of_a_blocked_run(ckpt, tmp_path, monkeypatch):
    """Stopped in its main pass and run again, a blocked calibration gives
    the uninterrupted bytes; the manifest records the shard count, and a
    resume at another count raises."""
    _, texact = _exact(ckpt)
    tokens = _tokens(ckpt)
    rdir = str(tmp_path / "resume")
    real = tcal._capture_block

    def dying(i, *a, **kw):
        if i == 1:
            raise RuntimeError("killed")
        return real(i, *a, **kw)

    monkeypatch.setattr(tcal, "_capture_block", dying)
    with pytest.raises(RuntimeError, match="killed"):
        tcal.quantize_model_calibrated(texact, tokens, "int2-mixed",
                                       tp_shards=2, resume_dir=rdir)
    monkeypatch.setattr(tcal, "_capture_block", real)
    with pytest.raises(ValueError, match="tp_shards=2"):
        tcal.quantize_model_calibrated(texact, tokens, "int2-mixed",
                                       resume_dir=rdir)
    resumed, _ = tcal.quantize_model_calibrated(
        texact, tokens, "int2-mixed", tp_shards=2, resume_dir=rdir)
    straight = _both(ckpt, "int2-mixed")[1][0]
    a = resumed.state_dict()
    b = straight.state_dict()
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert resumed.blocks[0].attn.o_proj.shards == 2


def test_a_blocked_model_is_not_written(ckpt, tmp_path):
    """``export_runtime`` refuses a model that carries a blocked layer: a
    placement artifact, not a one-device file."""
    model = _both(ckpt, "int2-mixed")[1][0]
    with pytest.raises(ValueError, match="placement artifact"):
        texport.export_runtime(model, tmp_path / "out")
    assert not (tmp_path / "out" / "runtime.safetensors").exists()


# ------------------------------------------------ 2 gloo ranks


CASES = [("int2-mixed", [[5, 17, 99, 3, 41, 7, 250, 12]], [[31]]),
         ("int3-mixed", [[2, 71, 13, 200, 9, 44]], [[17]]),
         ("int4-mixed", [[9, 8, 7, 6, 5, 4, 3, 2, 1]], [[100]])]
# the case whose ranks' logits are also held to vptq_tpu's forward_tp (a
# Pallas forward in interpret mode compiles for seconds: one of them)
JAX_FORWARD = "int3-mixed"


@pytest.fixture(scope="module", autouse=True)
def rank_job(ckpt, tmp_path_factory):
    """The file's one spawn of 2 gloo ranks, started before its first test
    so that the ranks run beside the tests of this process;
    :func:`ranks` waits for them."""
    tmp = tmp_path_factory.mktemp("tp_calibrate_ranks")
    other = str(tmp / "other")
    shutil.copytree(ckpt, other)
    spec = dict(
        cases=[dict(name=fmt, ckpt=ckpt, fmt=fmt, calibration=CALIBRATION,
                    tokens=toks, next=nxt) for fmt, toks, nxt in CASES],
        chat=CHAT,
        chat_argv=["--model", ckpt, "--chat", "--chat-system-prompt", "be",
                   "--tp", str(WORLD), "--device", "cpu", *GREEDY],
        web_argv=["--model", ckpt, "--model", other, "--port", "0",
                  "--tp", str(WORLD), "--device", "cpu",
                  "--max-new-tokens", "6", "--max-seq", "64",
                  "--temperature", "0"],
        web=_web_requests(other),
    )
    torch.save(spec, tmp / "spec.pt")
    job = dict(tmp=tmp, other=other, ctx=start_ranks(
        tp_rank_calibrated, WORLD, tmp, str(tmp / "spec.pt"), str(tmp)))
    yield job
    if not job.get("joined"):
        join_ranks(job["ctx"])


@pytest.fixture(scope="module")
def ranks(rank_job):
    """The ranks' results and the web app's second model."""
    rank_job["joined"] = True
    join_ranks(rank_job["ctx"])
    return ([torch.load(rank_job["tmp"] / f"cal{r}.pt")
             for r in range(WORLD)], rank_job["other"])


def _web_requests(other):
    hi = {"messages": [{"role": "user", "content": "hi"}]}
    chat = ("/api/chat", hi)
    # a prompt longer than the cache (refused on every rank), and a
    # streaming client that goes away mid-answer
    long = ("/api/chat", {"messages": [{"role": "user", "content": "x" * 80}]})
    gone = ("/api/chat", dict(hi, stream=True))
    return [chat, long, gone, chat, ("/api/model", {"name": other}), chat]


def _one_device_blocked(path, fmt):
    """The one-device blocked calibration, as the loader converts it."""
    _, texact = _exact(path)
    whole, _ = tcal.quantize_model_calibrated(texact, _tokens(path), fmt,
                                              tp_shards=WORLD)
    whole.lm_head = _calibrated_lm_head(whole.lm_head, fmt, False)
    return whole


def _jax_model(model, root: Path):
    """vptq_tpu's model holding the port's fused ``model``, its blocked
    layers as they are: the tensors written as a runtime file (not through
    ``export_runtime``, which refuses a blocked model) and read by
    vptq_tpu's reader, which checks no width."""
    flat = texport._flatten_model(model)
    bf16 = [k for k, t in flat.items() if t.dtype == torch.bfloat16]
    for k in bf16:
        flat[k] = flat[k].view(torch.uint16)
    root.mkdir()
    write_safetensors(flat, root / "runtime.safetensors")
    (root / "runtime_config.json").write_text(json.dumps(dict(
        format_version=texport._FORMAT_VERSION,
        model_config=model.cfg.to_dict(), bf16_keys=bf16)))
    return jexport.load_runtime_model(str(root))


@pytest.mark.parametrize("fmt,tokens,nxt", CASES)
def test_ranks_hold_the_placed_calibration(ranks, ckpt, fmt, tokens, nxt,
                                           tmp_path):
    """Each rank's shard is byte-equal to placing the one-device blocked
    calibration, by the port's ``tp_place_model(reencode_rows=False)``
    and by vptq_tpu's (which slices the blocks by its own code); the
    ranks' ``forward_tp`` logits are within 1e-4 of max of the one-device
    model run shard by shard (``tp.shards_summed``), over a prefill and
    a decode step, and, for ``JAX_FORWARD``, over the prefill of
    vptq_tpu's ``forward_tp`` of its placement; their greedy tokens are
    the one device's."""
    results, _ = ranks
    whole = _one_device_blocked(ckpt, fmt)
    jmesh = j_make_mesh(data=1, model=WORLD,
                        devices=np.asarray(jax.devices()[:WORLD]))
    jplaced, specs = jtp.tp_place_model(
        _jax_model(trt.fuse_model(copy.deepcopy(whole)), tmp_path / "jax"),
        jmesh, reencode_rows=False)
    jshards = _shards(jplaced, jmesh)
    with open(f"{ckpt}/config.json") as f:
        hf_config = json.load(f)
    for r, res in enumerate(results):
        placed = tp.tp_place_model(whole, Mesh(data=1, model=WORLD, rank=r),
                                   reencode_rows=False)
        got = res[fmt]["bytes"]
        for want in (_state_bytes(placed), _state_bytes(
                convert_shard(jshards, hf_config, r, device="cpu"))):
            assert sorted(got) == sorted(want)
            for k in want:
                assert torch.equal(got[k], want[k]), (r, k)
    summed = tp.shards_summed(whole)
    cache = init_cache(whole.cfg, 1, 64, torch.float32, "cpu")
    with torch.inference_mode():
        logits, cache = forward(summed, torch.tensor(tokens), cache,
                                dtype=torch.float32, fresh_prefill=True)
        step, _ = forward(summed, torch.tensor(nxt), cache,
                          dtype=torch.float32)
    pairs = [("logits", logits), ("step", step)]
    if fmt == JAX_FORWARD:
        jcache = jtp.shard_cache_tp(
            j_init_cache(whole.cfg, 1, 64, jnp.float32), jmesh)
        with jmesh:
            jlogits, _ = jtp.forward_tp(
                jplaced, jnp.asarray(tokens, jnp.int32), jcache, specs,
                jmesh, dtype=jnp.float32, fresh_prefill=True)
        pairs.append(("logits", torch.from_numpy(np.array(jlogits))))
    for res in results:
        for key, want in pairs:
            got = res[fmt][key]
            assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    gen = Generator(summed, max_seq=64, dtype=torch.float32,
                    prompt_buckets=(16, 32))
    want = gen.generate(tokens[0], max_new_tokens=8)
    assert [res[fmt]["greedy"] for res in results] == [want] * WORLD


def test_chat_under_tp_is_one_devices(ranks, ckpt, capsys, monkeypatch):
    """``--chat --tp 2``: rank 0 prints what one device's chat prints for
    the same turns (a ``clear`` among them), the other rank nothing and
    never reads the terminal."""
    results, _ = ranks
    lines = iter(CHAT)
    monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
    assert cli.main(["--model", ckpt, "--chat", "--chat-system-prompt", "be",
                     "--device", "cpu", *GREEDY]) == 0
    want = capsys.readouterr().out
    assert want.count("Assistant: ") == 2
    assert [r["chat_rc"] for r in results] == [0] * WORLD
    assert results[0]["chat_out"] == want
    assert results[1]["chat_out"] == ""


def test_web_app_under_tp_is_one_devices(ranks, ckpt):
    """The web app under ``--tp 2``: rank 0 serves, the other follows; the
    contents before and after a model switch are one device's
    ``Generator``'s at temperature 0 on the same tokenizer. A prompt
    longer than the cache is refused and a streaming client that goes
    away mid-answer gets no more deltas, and each time the ranks go on
    together: the next request serves."""
    from transformers import AutoTokenizer

    results, other = ranks
    assert [r["web_rank0"] for r in results] == [True, False]
    tok = AutoTokenizer.from_pretrained(ckpt)
    model = load_model(ckpt, dtype=torch.bfloat16, runtime_format="int8",
                       device="cpu")
    gen = Generator(model, max_seq=64)
    ids = tok.apply_chat_template([{"role": "user", "content": "hi"}],
                                  add_generation_prompt=True)
    out = gen.generate(ids, max_new_tokens=6, temperature=0.0,
                       eos_token_id=tok.eos_token_id)
    want = tok.decode(out, skip_special_tokens=True)
    chat0, long, gone, again, switched, chat1 = results[0]["web"]
    assert "max_seq 64" in long["error"]
    assert gone == [{"done": True, "error": "client gone"}]
    assert switched == {"current": other}
    assert [c["content"] for c in (chat0, again, chat1)] == [want] * 3
