"""Shared helpers of the tests that hold vptq_tpu_torch against vptq_tpu."""

import numpy as np
import torch

from vptq_tpu_torch.config import VQLinearConfig
from vptq_tpu_torch.layers.vqlinear import VQLinear
from vptq_tpu_torch.ops.packing import to_index_plane

# The tests run in several worker processes at once on a few cores; torch's
# default of one thread per core in every worker oversubscribes them, and
# the many small ops of these tiny models then run tens of times slower.
torch.set_num_threads(1)

# tiny GQA Llama: 2 layers, width 64, 4 heads over 2 KV heads
TINY = dict(
    vocab_size=256, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    head_dim=16,
)
# llama3 scaling whose thresholds fall inside head_dim 16's frequencies,
# so the scaled, smoothed and unscaled branches are all taken
LLAMA3_SCALING = {
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 64,
}
VQ = dict(
    vector_len=8, num_centroids=4096, num_res_centroids=256,
    enable_norm=True, enable_perm=True, is_indice_packed=True,
)


def tensor(a, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def jax_params(model) -> dict:
    """Flat {tree path: numpy array} of a vptq_tpu pytree."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(model)[0]:
        parts = [
            str(getattr(k, "name", getattr(k, "idx", getattr(k, "key", k))))
            for k in path
        ]
        out[".".join(parts)] = np.asarray(leaf)
    return out


def port_layer(planes, cfg) -> VQLinear:
    """The port's VQLinear holding vptq_tpu synth planes."""
    tcfg = VQLinearConfig.from_dict(cfg.to_dict())

    def plane(name, k):
        a = planes[name]
        return None if a is None else to_index_plane(tensor(a, torch.int64), k)

    perm = planes["perm"]
    return VQLinear(
        centroids=tensor(planes["centroids"]),
        ids=plane("ids", cfg.num_main_centroids),
        res_centroids=tensor(planes["res_centroids"]),
        res_ids=plane("res_ids", cfg.num_main_res_centroids),
        outlier_centroids=tensor(planes["outlier_centroids"]),
        outlier_ids=plane("outlier_ids", cfg.num_outlier_centroids),
        inv_perm=None if perm is None else torch.argsort(tensor(perm, torch.int64)),
        weight_scale=tensor(planes["weight_scale"]),
        weight_bias=tensor(planes["weight_bias"]),
        bias=tensor(planes["bias"]),
        cfg=tcfg,
    )


def xla_cpu_silu(x):
    """``jax.nn.silu`` as XLA's CPU backend lowers it: ``x * (1 / (1 +
    exp(-x)))``, each op rounded to the input's dtype. In bf16 the port's
    ``F.silu`` rounds once, so one down_proj input element in a few
    differs by a bf16 ulp and a greedy token on a near tie can part; with
    this in its place the port's bf16 logits equal those of vptq_tpu's
    op-by-op forward bit for bit (``tests/test_torch_cli.py``). Tests that
    hold bf16 text to the JAX package's swap it in with
    ``monkeypatch.setattr(F, "silu", ...)``."""
    return x * (1 / (1 + torch.exp(-x)))


# ---------------------------------------------------------------- ranks
# The tensor-parallel tests run the port as ranks of a gloo group on the
# CPU, each a process started by ``torch.multiprocessing.spawn``; the
# functions those processes run live here, in a module that imports no
# JAX, so that no rank loads it.


def start_ranks(fn, world: int, tmp, *args):
    """``fn(rank, world, store, *args)`` on ``world`` spawned ranks that
    rendezvous through a file store under ``tmp`` (no port to collide
    with another test process's); returns at once with their context,
    for :func:`join_ranks`."""
    import torch.multiprocessing as mp

    return mp.spawn(fn, args=(world, str(tmp / f"store{world}"), *args),
                    nprocs=world, join=False)


def join_ranks(ctx) -> None:
    """Wait for every rank of :func:`start_ranks`; a rank that failed
    raises here."""
    while not ctx.join():
        pass


def spawn_ranks(fn, world: int, tmp, *args) -> None:
    """:func:`start_ranks`, then :func:`join_ranks`."""
    join_ranks(start_ranks(fn, world, tmp, *args))


def _join(rank: int, world: int, store: str) -> None:
    from vptq_tpu_torch.parallel import distributed

    distributed.initialize("gloo", f"file://{store}", rank, world,
                           timeout_s=120.0)


def _bytes_of(model) -> dict:
    return {k: v.contiguous().view(torch.uint8).clone()
            for k, v in model.state_dict().items()}


def tp_rank_cases(rank: int, world: int, store: str, spec: str,
                  out_dir: str) -> None:
    """Every case of ``spec`` (a ``torch.save``d list of dicts) on this
    rank: the sharded load (``load_model(mesh=)``), its bytes, the
    placement of a one-device load (``tp_place_model``), ``forward_tp``'s
    logits over a prefill and a decode step, and where asked the
    ``Generator(mesh=)`` (greedy, and sampled twice) and the
    ``Scheduler(mesh=)``; the results to ``out_dir/<rank>.pt``."""
    import torch.distributed as dist

    from vptq_tpu_torch.models.loader import load_model
    from vptq_tpu_torch.parallel.mesh import make_mesh
    from vptq_tpu_torch.parallel.tp import (
        forward_tp,
        init_cache_tp,
        tp_place_model,
    )
    from vptq_tpu_torch.serving.generate import Generator
    from vptq_tpu_torch.serving.scheduler import Scheduler
    from vptq_tpu_torch.utils import memory as hbm

    _join(rank, world, store)
    results = {}
    try:
        for case in torch.load(spec):
            mesh = make_mesh(data=case["data"], model=world // case["data"],
                             device="cpu")
            kw = dict(dtype=torch.float32, runtime_format=case["fmt"])
            model = load_model(case["ckpt"], mesh=mesh, **kw)
            out = {"bytes": _bytes_of(model)}
            if case.get("estimate"):
                # the loader's own dtype, which the estimate counts
                out["model_bytes"] = hbm.model_bytes(load_model(
                    case["ckpt"], mesh=mesh, runtime_format=case["fmt"]))
            if case.get("place"):
                one = load_model(case["ckpt"], device="cpu", **kw)
                out["placed"] = _bytes_of(tp_place_model(one, mesh))
            tokens = torch.tensor(case["tokens"])
            cache = init_cache_tp(model.cfg, tokens.shape[0], 128,
                                  torch.float32, mesh)
            with torch.inference_mode():
                out["logits"], _ = forward_tp(model, tokens, cache, mesh,
                                              torch.float32, True)
                nxt = torch.tensor(case["next"])
                out["step"], _ = forward_tp(model, nxt, cache, mesh,
                                            torch.float32)
            if case.get("ep"):
                out["ep_gap"] = _ep_gap(case, mesh, kw)
            if case.get("generate"):
                gen = Generator(model, max_seq=64, dtype=torch.float32,
                                prompt_buckets=(16, 32), mesh=mesh)
                prompt = case["generate"]
                out["greedy"] = gen.generate(prompt, max_new_tokens=8,
                                             chunk_size=4)
                out["sampled"] = [
                    gen.generate(prompt, max_new_tokens=8, temperature=0.7,
                                 seed=5, chunk_size=4) for _ in range(2)]
                out["decode_mode"] = gen.decode_mode
            if case.get("schedule"):
                sched = Scheduler(model, max_batch=2, max_seq=64,
                                  dtype=torch.float32, chunk=4,
                                  prompt_buckets=(16, 32), mesh=mesh)
                ids = [sched.submit(p, max_new_tokens=n)
                       for p, n in case["schedule"]]
                outs = sched.run()
                out["served"] = [outs[i] for i in ids]
            results[case["name"]] = out
            dist.barrier()
        torch.save(results, f"{out_dir}/{rank}.pt")
    finally:
        dist.destroy_process_group()


def tp_rank_codebook(rank: int, world: int, store: str, spec: str,
                     out_dir: str) -> None:
    """Every case of ``spec`` on this rank: the codebook model under a
    data-1 mesh (``load_model(mesh=)``), ``forward_tp``'s logits over a
    fresh prefill and one decode step, and ``Generator(mesh=)``'s greedy
    tokens; the results to ``out_dir/<rank>.pt``."""
    import torch.distributed as dist

    from vptq_tpu_torch.models.loader import load_model
    from vptq_tpu_torch.parallel.mesh import make_mesh
    from vptq_tpu_torch.parallel.tp import forward_tp, init_cache_tp
    from vptq_tpu_torch.serving.generate import Generator

    _join(rank, world, store)
    results = {}
    try:
        mesh = make_mesh(data=1, model=world, device="cpu")
        for case in torch.load(spec):
            model = load_model(case["ckpt"], mesh=mesh, dtype=torch.float32,
                               runtime_format="codebook")
            tokens = torch.tensor(case["tokens"])
            cache = init_cache_tp(model.cfg, tokens.shape[0], 64,
                                  torch.float32, mesh)
            out = {"kinds": sorted({type(m).__name__
                                    for m in model.modules()})}
            with torch.inference_mode():
                out["logits"], _ = forward_tp(model, tokens, cache, mesh,
                                              torch.float32, True)
                out["step"], _ = forward_tp(model, torch.tensor(
                    case["next"]), cache, mesh, torch.float32)
            gen = Generator(model, max_seq=64, dtype=torch.float32,
                            prompt_buckets=(16,), mesh=mesh)
            out["greedy"] = gen.generate(case["prompt"], max_new_tokens=8,
                                         chunk_size=4)
            results[case["name"]] = out
            dist.barrier()
        torch.save(results, f"{out_dir}/{rank}.pt")
    finally:
        dist.destroy_process_group()


def tp_rank_cli(rank: int, world: int, store: str, argv: list,
                out_dir: str) -> None:
    """``python -m vptq_tpu_torch ... --tp world`` on this rank, its stdout
    and the tokens of the same request through its ``Generator`` to
    ``out_dir/cli<rank>.pt``."""
    import contextlib
    import io

    import torch.distributed as dist

    from vptq_tpu_torch.serving import cli

    _join(rank, world, store)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        args = cli.build_parser().parse_args(argv)
        tokenizer = cli._tokenizer(args)
        _, gen = cli._load(args)
        ids = tokenizer(args.prompt, return_tensors=None)["input_ids"]
        toks = gen.generate(ids, max_new_tokens=args.max_new_tokens,
                            eos_token_id=tokenizer.eos_token_id,
                            temperature=args.temperature, seed=args.seed)
        # the completion as the CLI streams it, a token at a time
        text = "".join(tokenizer.decode([t], skip_special_tokens=True)
                       for t in toks)
        torch.save(dict(rc=rc, out=buf.getvalue(), tokens=toks, text=text),
                   f"{out_dir}/cli{rank}.pt")
    finally:
        dist.destroy_process_group()


def tp_rank_engine(rank: int, world: int, store: str, ckpt: str,
                   out_dir: str) -> None:
    """``from_pretrained(tp=world)`` on this rank serving one request; its
    tokens, and what ``from_pretrained(tp=world)`` with no ``device``
    raises when CUDA is missing, to ``out_dir/engine<rank>.pt``."""
    from unittest import mock

    import torch.distributed as dist

    from vptq_tpu_torch import AutoModelForCausalLM

    _join(rank, world, store)
    try:
        with mock.patch("torch.cuda.is_available", return_value=False):
            try:
                AutoModelForCausalLM.from_pretrained(ckpt, tp=world)
                no_card = None
            except RuntimeError as e:
                no_card = str(e)
        engine = AutoModelForCausalLM.from_pretrained(
            ckpt, device="cpu", tp=world, dtype=torch.float32, max_seq=32)
        torch.save(dict(tokens=engine.generate([1, 2, 3], max_new_tokens=4),
                        mesh=(engine.mesh.data, engine.mesh.model),
                        decode_mode=engine.generator.decode_mode,
                        no_card=no_card),
                   f"{out_dir}/engine{rank}.pt")
    finally:
        dist.destroy_process_group()


def _ep_gap(case, mesh, kw) -> float:
    """``moe_forward_ep`` on this rank's experts (``shard_stacked_experts``
    of a one-device load's first MoE block) against the one-device routed
    experts on the same tokens, both MoE paths: the largest gap."""
    from vptq_tpu_torch.models import llama
    from vptq_tpu_torch.models.loader import load_model
    from vptq_tpu_torch.parallel.expert_parallel import (
        moe_forward_ep,
        shard_stacked_experts,
    )

    moe = load_model(case["ckpt"], device="cpu", **kw).blocks[0].mlp
    local = shard_stacked_experts(moe.stacked, mesh)
    n_exp = moe.stacked.gate_up_wq.shape[0]
    gen = torch.Generator().manual_seed(3)
    gap = 0.0
    for tokens in (3, 70):  # the pairs path, every local expert
        x = torch.randn((1, tokens, moe.stacked.down_wq.shape[1]),
                        generator=gen)
        logits = moe.router(x).to(torch.float32)
        top_w, top_ids = llama._top_k(logits, moe.num_experts_per_tok)
        top_w = torch.softmax(top_w, dim=-1)
        got = moe_forward_ep(local, x, top_ids, top_w, n_exp, mesh)
        want = llama._route_moe(x, top_ids, top_w, n_exp, [], moe.stacked)
        gap = max(gap, (got - want.to(torch.float32)).abs().max().item())
    return gap


def cp_rank_cases(rank: int, world: int, store: str, spec: str,
                  out_dir: str) -> None:
    """Context parallelism on this rank (``spec``: a ``torch.save``d dict):
    ``ring_attention`` over the whole world as the data axis on this
    rank's chunk of each case's q / k / v; then each model case on its
    data × model mesh: ``prefill_cp``'s chunk of logits and the cache it
    leaves, the row ``cp_logits_row`` hands every rank, a decode step by
    ``forward_tp`` from that cache, and where asked the ``Generator(mesh=)``
    and the ``Scheduler(mesh=)``; the results to ``out_dir/cp<rank>.pt``."""
    import torch.distributed as dist

    from vptq_tpu_torch.models.llama import init_cache
    from vptq_tpu_torch.models.loader import load_model
    from vptq_tpu_torch.parallel.mesh import make_mesh
    from vptq_tpu_torch.parallel.ring import ring_attention
    from vptq_tpu_torch.parallel.tp import (
        cp_logits_row,
        forward_tp,
        prefill_cp,
    )
    from vptq_tpu_torch.serving.generate import Generator
    from vptq_tpu_torch.serving.scheduler import Scheduler

    _join(rank, world, store)
    spec = torch.load(spec)
    results = {"ring": {}}
    try:
        axis = make_mesh(data=world, model=1, device="cpu").cp
        for name, (q, k, v) in spec["ring"].items():
            c = q.shape[1] // world
            part = slice(rank * c, (rank + 1) * c)
            results["ring"][name] = ring_attention(
                q[:, part], k[:, part], v[:, part], axis, q.shape[-1] ** -0.5)
        for case in spec["cases"]:
            mesh = make_mesh(data=case["data"], model=world // case["data"],
                             device="cpu")
            model = load_model(case["ckpt"], mesh=mesh, dtype=torch.float32,
                               runtime_format=case["fmt"])
            tokens = torch.tensor(case["tokens"])
            n = tokens.shape[1]
            cache = init_cache(model.cfg, 1, 32, torch.float32, "cpu",
                               tp_size=mesh.model)
            out = {}
            with torch.inference_mode():
                out["logits"], cache = prefill_cp(model, tokens, cache, mesh,
                                                  torch.float32)
                out["row"] = cp_logits_row(out["logits"], n - 1, mesh)
                out["k"] = [t[:, :n].clone() for t in cache.k]
                out["v"] = [t[:, :n].clone() for t in cache.v]
                out["lengths"] = cache.lengths.clone()
                out["max_len"] = cache.max_len
                out["step"], _ = forward_tp(model, torch.tensor(case["next"]),
                                            cache, mesh, torch.float32)
            if case.get("generate"):
                gen = Generator(model, max_seq=64, dtype=torch.float32,
                                prompt_buckets=(16,), mesh=mesh)
                out["greedy"] = gen.generate(case["generate"],
                                             max_new_tokens=10)
                out["singles"] = [gen.generate(p, max_new_tokens=6)
                                  for p in case["schedule"]]
            if case.get("schedule"):
                sched = Scheduler(model, max_batch=2, max_seq=64,
                                  dtype=torch.float32, chunk=4,
                                  prompt_buckets=(16,), mesh=mesh)
                ids = [sched.submit(p, max_new_tokens=6)
                       for p in case["schedule"]]
                outs = sched.run()
                out["served"] = [outs[i] for i in ids]
                out["slots_here"] = sched._rows
            results[case["name"]] = out
            dist.barrier()
        torch.save(results, f"{out_dir}/cp{rank}.pt")
    finally:
        dist.destroy_process_group()


def pp_rank_cases(rank: int, world: int, store: str, spec: str,
                  out_dir: str) -> None:
    """``TPPipelineRunner`` on this rank for each case of ``spec`` (a
    ``torch.save``d dict): a fresh prefill and a decode step, and where
    asked ``forward_pipelined`` over microbatches with the stage steps
    this rank ran; then what each refused construction raises. The
    results to ``out_dir/pp<rank>.pt``."""
    import torch.distributed as dist

    from vptq_tpu_torch.models.loader import load_model
    from vptq_tpu_torch.parallel.pipeline import TPPipelineRunner

    _join(rank, world, store)
    spec = torch.load(spec)
    results = {}
    try:
        with torch.inference_mode():
            for case in spec["cases"]:
                model = load_model(case["ckpt"], dtype=torch.float32,
                                   runtime_format=case["fmt"], device="cpu")
                runner = TPPipelineRunner(model, tp=case["tp"], max_seq=16,
                                          dtype=torch.float32, device="cpu")
                out = dict(stage=runner.stage, n_stages=runner.n_stages)
                out["logits"] = runner.forward(torch.tensor(case["tokens"]),
                                               fresh=True)
                out["step"] = runner.forward(torch.tensor(case["next"]))
                chunks = case.get("chunks")
                if chunks:
                    piped = TPPipelineRunner(
                        model, tp=case["tp"], max_seq=16,
                        batch=len(chunks), dtype=torch.float32, device="cpu")
                    calls = []
                    inner = piped._run_stage

                    def spy(s, *args, inner=inner, calls=calls):
                        calls.append(s)
                        return inner(s, *args)

                    piped._run_stage = spy
                    out["piped"] = piped.forward_pipelined(
                        [torch.tensor(c) for c in chunks], fresh=True)
                    out["piped_calls"] = calls
                results[case["name"]] = out
                dist.barrier()
        refused = {}
        for name, (ckpt, tp) in spec["refusals"].items():
            model = load_model(ckpt, dtype=torch.float32,
                               runtime_format="int8", device="cpu")
            try:
                TPPipelineRunner(model, tp=tp, device="cpu")
                refused[name] = None
            except (ValueError, NotImplementedError) as e:
                refused[name] = (type(e).__name__, str(e))
        results["refusals"] = refused
        torch.save(results, f"{out_dir}/pp{rank}.pt")
    finally:
        dist.destroy_process_group()


def tp_rank_calibrated(rank: int, world: int, store: str, spec: str,
                       out_dir: str) -> None:
    """Calibration under a mesh and the interactive entry points under
    ``--tp`` on this rank (``spec``: a ``torch.save``d dict): each
    calibrated case's sharded load (``load_model(mesh=, calibration=)``),
    its bytes and ``forward_tp``'s logits over a prefill and a decode
    step, the ``Generator(mesh=)``'s greedy tokens; then the CLI's chat
    (rank 0's ``input()`` fed ``spec["chat"]``, the other ranks' never
    read) and the web app (rank 0 serving ``spec["web"]``'s requests over
    HTTP, the other ranks following: a refused one, a streaming one whose
    client has gone, a model switch), with their stdout and contents (a
    stream's as its events); the results to ``out_dir/cal<rank>.pt``."""
    import contextlib
    import io
    import json
    import threading
    import urllib.error
    import urllib.request
    from unittest import mock

    import torch.distributed as dist

    from vptq_tpu_torch.models.loader import load_model
    from vptq_tpu_torch.parallel.mesh import make_mesh
    from vptq_tpu_torch.parallel.tp import forward_tp, init_cache_tp
    from vptq_tpu_torch.serving import cli, webapp
    from vptq_tpu_torch.serving.generate import Generator

    _join(rank, world, store)
    spec = torch.load(spec)
    results = {}
    try:
        mesh = make_mesh(data=1, model=world, device="cpu")
        for case in spec["cases"]:
            model = load_model(case["ckpt"], mesh=mesh, dtype=torch.float32,
                               runtime_format=case["fmt"],
                               calibration=case["calibration"])
            out = {"bytes": _bytes_of(model)}
            tokens = torch.tensor(case["tokens"])
            cache = init_cache_tp(model.cfg, 1, 64, torch.float32, mesh)
            with torch.inference_mode():
                out["logits"], _ = forward_tp(model, tokens, cache, mesh,
                                              torch.float32, True)
                out["step"], _ = forward_tp(model, torch.tensor(case["next"]),
                                            cache, mesh, torch.float32)
            gen = Generator(model, max_seq=64, dtype=torch.float32,
                            prompt_buckets=(16, 32), mesh=mesh)
            out["greedy"] = gen.generate(case["tokens"][0], max_new_tokens=8)
            results[case["name"]] = out
            dist.barrier()

        lines = iter(spec["chat"])

        def typed(prompt=""):
            if rank:
                raise AssertionError("a rank other than 0 read the input")
            try:
                return next(lines)
            except StopIteration:
                raise EOFError from None

        buf = io.StringIO()
        with mock.patch("builtins.input", typed), \
                contextlib.redirect_stdout(buf):
            results["chat_rc"] = cli.main(spec["chat_argv"])
        results["chat_out"] = buf.getvalue()

        httpd = webapp.start(webapp.build_parser().parse_args(
            spec["web_argv"]))
        if httpd is not None:
            thread = threading.Thread(target=httpd.serve_forever,
                                      daemon=True)
            thread.start()
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            real_sse = webapp.Handler._sse_event

            def gone(handler, obj):
                # a streaming client that has gone: every delta's write
                # fails, as a closed socket's does
                if "delta" in obj:
                    raise BrokenPipeError("client gone")
                real_sse(handler, obj)

            contents = []
            with mock.patch.object(webapp.Handler, "_sse_event", gone):
                for path, obj in spec["web"]:
                    req = urllib.request.Request(
                        base + path, data=json.dumps(obj).encode(),
                        headers={"Content-Type": "application/json"})
                    try:
                        with urllib.request.urlopen(req) as resp:
                            body = resp.read().decode()
                    except urllib.error.HTTPError as e:
                        body = e.read().decode()
                    contents.append(
                        [json.loads(ev[6:]) for ev in body.split("\n\n")
                         if ev.startswith("data: ")]
                        if obj.get("stream") else json.loads(body))
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
            results["web"] = contents
        results["web_rank0"] = httpd is not None
        torch.save(results, f"{out_dir}/cal{rank}.pt")
    finally:
        dist.destroy_process_group()
