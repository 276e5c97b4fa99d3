"""Multi-device serving walkthrough: every parallelism mode of the port on
a tiny synthetic checkpoint.

The port of ``examples/multichip_demo.py``, whose five steps ran on a
virtual 8-device CPU mesh:

  1. plan — ``tools/plan.py`` for Llama-2-70B in int4 over 8 devices
     (budget table and placement, no weight read);
  2. TP — the int8 checkpoint loaded as each rank's shard
     (``load_model(mesh=)``) and served by ``Generator(mesh=)``;
  3. DP × TP — the same model on a 2 × 2 mesh of 4 ranks;
  4. CP — a ring-attention prefill over the data axis (``prefill_cp``),
     then one tensor-parallel decode step (``forward_tp``);
  5. PP — ``PipelineRunner`` over 2 stages, two microbatches through its
     1F schedule (``forward_pipelined``).

Steps 2–4 run in one spawn of 4 gloo ranks (a 2 × 2 mesh: batch 1 does
not divide the data axis, so each data rank serves it over its model
axis of 2, JAX's TP step); on the card they all share it (``cuda:0``), so
nothing here measures a speed. Step 5 runs in this process, both stages
on the one device. The lines are JAX's: ``TP tokens: ...``, ``CP prefill
+ TP decode next token: ...``, ``PP microbatch next tokens: ...``, ``demo
OK``::

    python -m vptq_tpu_torch.examples.multichip_demo [--device cpu]
        [--hbm-gb 16]

``--hbm-gb``: the memory of each planned device (default: the card's;
80, an H100's, with ``--device cpu``). Without a CUDA device it exits
non-zero unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
from pathlib import Path

import torch

from vptq_tpu_torch.models.loader import entry_device, load_model
from vptq_tpu_torch.utils.synth_checkpoint import (
    tiny_model_config,
    write_synthetic_checkpoint,
)

__all__ = ["CP_TOKENS", "PP_TOKENS", "TP_PROMPT", "main", "rank_job"]

WORLD = 4
TP_PROMPT = [1, 2, 3]
CP_TOKENS = [[1, 7, 42, 9, 3, 5, 2, 8]]
PP_TOKENS = ([[1, 2, 3]], [[9, 8, 7]])


def rank_job(rank: int, world: int, store: str, ckpt: str, device: str,
             out_dir: str) -> None:
    """Steps 2–4 on one rank of ``world`` gloo ranks (a 2 × 2 mesh); rank
    0 writes their results to ``out_dir/steps.json``."""
    import torch.distributed as dist

    from vptq_tpu_torch.models.llama import init_cache
    from vptq_tpu_torch.parallel import distributed
    from vptq_tpu_torch.parallel.mesh import make_mesh
    from vptq_tpu_torch.parallel.tp import (
        cp_logits_row,
        forward_tp,
        prefill_cp,
        shard_cache_tp,
    )
    from vptq_tpu_torch.serving.generate import Generator

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    distributed.initialize("gloo", f"file://{store}", rank, world)
    try:
        mesh = make_mesh(data=2, model=2, device=device)
        model = load_model(ckpt, runtime_format="int8", mesh=mesh)
        gen = Generator(model, max_seq=64, prompt_buckets=(16,), mesh=mesh)
        tp_tokens = gen.generate(TP_PROMPT, max_new_tokens=8)
        del gen
        tokens = torch.tensor(CP_TOKENS, device=mesh.device)
        cache = shard_cache_tp(
            init_cache(model.cfg, 1, 32, torch.bfloat16, mesh.device), mesh)
        with torch.inference_mode():
            logits, cache = prefill_cp(model, tokens, cache, mesh)
            last = cp_logits_row(logits, tokens.shape[1] - 1, mesh)
            nxt = last.argmax(-1, keepdim=True)
            logits, _ = forward_tp(model, nxt, cache, mesh)
        if rank == 0:
            Path(out_dir, "steps.json").write_text(json.dumps({
                "tp": tp_tokens, "cp": int(logits[0, -1].argmax()),
            }))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _plan(hbm_gb) -> None:
    from vptq_tpu_torch.tools import plan

    argv = ["--geometry", "llama2-70b", "--format", "int4", "--chips", "8"]
    if hbm_gb is not None:
        argv += ["--hbm-gb", str(hbm_gb)]
    plan.main(argv)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--hbm-gb", type=float, default=None)
    args = parser.parse_args(argv)
    device = entry_device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        device = torch.device("cuda", torch.cuda.current_device())
    hbm_gb = args.hbm_gb if args.hbm_gb or cuda else 80.0

    # 1. plan a deployment before reading any weight
    print("== plan: llama2-70b @ int4 on 8 devices ==")
    _plan(hbm_gb)

    import torch.multiprocessing as mp

    from vptq_tpu_torch.parallel.pipeline import PipelineRunner

    tmp = tempfile.mkdtemp(prefix="vptq_demo_")
    try:
        ckpt = str(Path(tmp, "ckpt"))
        write_synthetic_checkpoint(
            ckpt, tiny_model_config(tie_word_embeddings=False), seed=5)
        if cuda:
            # the ranks load the kernel the parent built
            from vptq_tpu_torch.ops import _build

            _build.build(["w8_matmul"])
        # 2.-4. TP, DP x TP and CP on one mesh of 4 ranks
        mp.spawn(rank_job, args=(WORLD, str(Path(tmp, "store")), ckpt,
                                 str(device), tmp),
                 nprocs=WORLD, join=True)
        steps = json.loads(Path(tmp, "steps.json").read_text())
        print("TP tokens:", steps["tp"])
        print("CP prefill + TP decode next token:", steps["cp"])

        # 5. pipeline stages with microbatch interleaving
        plain = load_model(ckpt, runtime_format="int8", device=device)
        pp = PipelineRunner(plain, [device, device], max_seq=32, batch=2)
        with torch.inference_mode():
            outs = pp.forward_pipelined(
                [torch.tensor(t, device=device) for t in PP_TOKENS],
                fresh=True)
        steps["pp"] = [int(o[0, -1].argmax()) for o in outs]
        print("PP microbatch next tokens:", steps["pp"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("demo OK")
    return steps


if __name__ == "__main__":
    main()
