"""The kernel phases of ``chip_smoke.py`` on several trees, in turns.

Compares versions of the kernels on one card in one run: each turn is a
fresh process in one tree (a checkout of the repository) that builds that
tree's kernels and runs that tree's own ``chip_smoke`` phases at the full
shapes: K3 ``w2_matmul``, K2 ``w4_matmul``, K4 ``w3_matmul``, K1
``w8_matmul`` and K7 ``bf16_matmul`` at the four linears of a
Llama-3.1-8B layer, the MoE kernels K6b ``w4_matmul_expert``, K5b
``w4_matmul_pairs``, K6a ``w8_matmul_expert`` and K5a ``w8_matmul_pairs``
at a Mixtral-8x7B expert's two shapes on stacks of 8, T = 1, 128, 512
and 2048 (K1–K4 also T = 4 and 16; K5: P = 2 and 16); and K8
``flash_attention`` at every case of
the tree's ``chip_smoke.FLASH_CASES`` (``phase_flash``); and the probe
phase (``phase_probes``: P1, P2, P3 and K2 beside them at the probe
scripts' Llama-2-7B shapes, T = 1, and P1, P2, P1c and P3 at the other
token counts the tree's phase takes; P1 / P2 at T = 8 and 16 the turn
times itself where the tree's phase does not). Each kernel is held
against its plain version, as the smoke holds it. The card's name and
power limit come first; then one line per (turn, kernel, scale group, T)
with ms, bound, plain and ``torch.matmul`` ms summed over the shapes (K8:
one line per case, its yardstick ``scaled_dot_product_attention``; a
probe: one line per mode and shape), and the device-to-host copies of
two launches each of K6b and K6a (T = 512, 2048) in the
``torch.profiler`` trace, with the names of their kernels. ``--probes-only`` runs the probe phase alone;
``--pairs-only`` K5a alone, at the tree's ``phase_moe_kernels`` on int8
stacks: Mixtral-8x7B's two expert shapes over 8 experts at P = 2 and 16
(a line sums a layer's gate_up and down) and Moonlight-16B-A3B's over 64
at P = 6, 48 and 384 (a line per shape: gate_up's group 2048, down's
512). ``--moe-steps DIR`` runs no kernel phase: on synthetic int8
checkpoints of Mixtral-8x7B (32 layers) and Moonlight-16B-A3B (27),
written once into DIR by the first turn and read by every turn, the
tree's graphed batch-1 decode step (``graph_breakdown``) and its batched
step of 8 slots (``batched_breakdown``: K5 at P = 8 × top-k), wall, busy
and each decode kernel's device ms.

    python -m vptq_tpu_torch.examples.kernel_turns \\
        --tree P=build/tree/parent --tree C=. --order P C C P \\
        [--out DIR] [--device cuda] \\
        [--probes-only | --pairs-only | --moe-steps DIR]

Without ``--tree`` and ``--order`` it runs one turn in the current
directory. ``--out`` keeps every row of each turn as
``DIR/turn_<n>_<label>.json``. With ``--device cpu`` the phases run at a
tiny size on the plain versions (a rehearsal); without a card and without
it, the script exits non-zero.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

from vptq_tpu_torch.examples.kernel_bench import card_line, pick_device

__all__ = ["main"]

# the kernels a turn runs: the smoke's phase_kernel for the four formats,
# phase_moe_kernels("int4") and ("int8") for the MoE pairs, phase_bf16,
# phase_flash; then phase_probes (K2 beside the probes)
KERNELS = ("w2_matmul", "w4_matmul", "w3_matmul", "w8_matmul",
           "w4_matmul_expert", "w4_matmul_pairs", "w8_matmul_expert",
           "w8_matmul_pairs", "bf16_matmul", "flash_attention")
PROBES = ("w4_probe_matmul", "w4_i32x8_matmul", "w4_raw_probe",
          "vq_smallk_matmul", "w4_matmul")

# One turn, run with ``python -c`` from the root of its tree so that the
# tree's own chip_smoke and vptq_tpu_torch are the ones imported:
# argv = label, device, out file ("" for none), "1" for the probe phase
# alone, "1" for K5a alone, the MoE steps' checkpoint directory ("" for
# none)
_TURN = r'''
import json, shutil, sys, time
from pathlib import Path
import torch
import chip_smoke as cs
from vptq_tpu_torch.ops import _build

label, dev, out, probes_only, pairs_only, moe_steps = sys.argv[1:7]
probes_only = probes_only == "1"
pairs_only = pairs_only == "1" or bool(moe_steps)
KERNELS = (() if probes_only else ("w8_matmul_pairs",) if pairs_only
           else %(kernels)r)
PROBES = () if pairs_only else %(probes)r
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
if dev == "cuda":
    _build.build(tuple(dict.fromkeys(KERNELS + PROBES)))
print(f"[{label}] build {time.perf_counter() - t0:.1f} s", flush=True)
shapes = cs.k1_shapes(cs.LLAMA31_8B)
moe_shapes = cs.moe_shapes(cs.MIXTRAL_8X7B)
probe_shapes = cs.PROBE_SHAPES
tokens, iters = (1, 128, 512, 2048), 20
flash_cases = cs.FLASH_CASES
if dev == "cpu":
    shapes = moe_shapes = [("a", 40, 1024), ("b", 24, 2048)]
    probe_shapes = (("a", 40, 2048), ("b", 24, 1024))
    tokens, iters = (1, 20), 1
    flash_cases = (("heads", 1, 40, 4, 2, 16, 1.0, True),)
rows = []
if moe_steps:
    from vptq_tpu_torch import AutoModelForCausalLM
    from vptq_tpu_torch.serving.scheduler import Scheduler

    models = (("Mixtral-8x7B", cs.MIXTRAL_8X7B),
              ("Moonlight-16B-A3B", cs.MOONLIGHT_16B))
    if dev == "cpu":
        models = tuple((n, dict(c, num_hidden_layers=1)) for n, c in models)
    for name, cfg in models:
        path = Path(moe_steps) / name
        if not (path / "config.json").exists():
            made, secs = cs.write_checkpoint(cfg, cs.V8_K65536)
            shutil.move(made, path)
            print(f"[{label}] {name} checkpoint written in {secs:.1f} s",
                  flush=True)
        engine = AutoModelForCausalLM.from_pretrained(
            str(path), runtime_format="int8", device=dev, max_seq=2048)
        model, gen = engine.model, engine.generator
        prompt = list(range(1, 17))
        with torch.inference_mode():
            gen.generate(prompt, max_new_tokens=4)
        if dev == "cuda":
            tags = {k: cs.kernel_fns(k)[0].trace_tags
                    for k in ("w8_matmul", "w8_matmul_pairs")}
            one = cs.graph_breakdown(model, gen, prompt, tags, "int8")
            sched = Scheduler(model, dtype=gen.dtype, **cs.SERVE)
            lengths = [1014, 3, 250, 600, 17, 900, 1009, 128]
            eight = cs.batched_breakdown(sched, lengths, tags, "int8")
            for what, r in (("batch 1", one), ("8 slots", eight)):
                print(f"[{label}] {name} int8 {what} step: " + json.dumps(
                    dict(wall_ms=r["wall_ms"], busy_ms=r["device_busy_ms"],
                         kernels_per_step=r["kernels_per_step"],
                         kernel_ms=r["kernel_ms"], routes=r["routes"])),
                      flush=True)
            del sched
        del engine, model, gen
        torch.cuda.empty_cache() if dev == "cuda" else None
    KERNELS = ()
if pairs_only and not moe_steps:
    moon = cs.moe_shapes(cs.MOONLIGHT_16B) if dev == "cuda" else moe_shapes
    rows += cs.phase_moe_kernels("int8", dev, moe_shapes, tokens=(),
                                 pairs=(2, 16), iters=iters)
    rows += cs.phase_moe_kernels(
        "int8", dev, moon, n_experts=cs.MOONLIGHT_16B["n_routed_experts"],
        top_k=cs.MOONLIGHT_16B["num_experts_per_tok"], tokens=(),
        pairs=(6, 48, 384), iters=iters, in_record=False)
    KERNELS = ()
for name in KERNELS:
    if name in cs.FORMAT_KERNEL.values():
        # K1–K4 also at T = 4 and 16: their decode GEMV's two instances
        toks = (tokens[0], 4, 16) + tokens[1:]
        rows += cs.phase_kernel(name, dev, shapes, toks, iters=iters)
if KERNELS and not probes_only:
    for fmt in ("int4", "int8"):
        rows += cs.phase_moe_kernels(fmt, dev, moe_shapes, tokens=tokens,
                                     iters=iters)
    rows += cs.phase_bf16(dev, shapes, tokens, iters=iters)
    rows += cs.phase_flash(dev, flash_cases, iters=iters)
if PROBES:
    rows += cs.phase_probes(dev, shapes=probe_shapes, iters=iters,
                            cases=False)
    # P1 / P2 at the token counts the tree's probe phase lacks (before
    # their ring GEMV it took T = 1 alone), timed as the phase times them
    from vptq_tpu_torch.examples.kernel_bench import flush_buffer
    from vptq_tpu_torch.ops.packing import unpack_int4
    from vptq_tpu_torch.ops.w4_probe_matmul import (
        F32_X_MODES, W4_PROBE_MODES)

    have = {(r["mode"], r["shape"], r["T"]) for r in rows
            if r["kernel"] == "w4_probe_matmul"}
    fn, ref = cs.kernel_fns("w4_probe_matmul")
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = flush_buffer(dev)
    for shape, out_f, in_f in probe_shapes:
        todo = [(m, t) for m in W4_PROBE_MODES for t in (8, 16)
                if (m, shape, t) not in have]
        if not todo:
            continue
        wq = torch.randint(-120, 120, (out_f, in_f // 2), generator=gen,
                           device=dev, dtype=torch.int8)
        sc = (0.005 * (1 + torch.rand((in_f // 128, out_f), generator=gen,
                                      device=dev))).to(torch.bfloat16)
        w = cs._dequant(unpack_int4(wq), sc)
        xs = torch.randn((16, in_f), generator=gen, device=dev).to(
            torch.bfloat16)
        for mode, t in todo:
            xm = xs[:t].float() if mode in F32_X_MODES else xs[:t]
            reads = (xm, wq, sc[::2] if mode == "g256" else sc)
            nbytes = (sum(a.numel() * a.element_size() for a in reads)
                      + t * out_f * 2)
            rows.append(dict(
                kernel="w4_probe_matmul", mode=mode, shape=shape, unit="T",
                T=t, out=out_f, in_p=in_f, **cs.check_and_time(
                    "w4_probe_matmul", f"{mode} {shape} T={t}",
                    lambda: fn(xm, wq, sc, mode, out_dtype=torch.bfloat16),
                    lambda: ref(xm, wq, sc, mode, out_dtype=torch.bfloat16),
                    lambda: torch.matmul(xs[:t], w.t()),
                    nbytes, 2 * t * out_f * in_f, dev, iters, flush)))
if dev == "cuda" and KERNELS and not probes_only:
    # device-to-host copies of two launches of each expert kernel at
    # Mixtral's down shape: the id stays on the card
    from torch.profiler import ProfilerActivity, profile

    e = torch.tensor(7, dtype=torch.int32, device=dev)
    x = torch.randn((2048, 14336), device=dev).to(torch.bfloat16)
    for name, cols, sc in (
        ("w4_matmul_expert", 7168,
         torch.ones((8, 112, 4096), dtype=torch.bfloat16, device=dev)),
        ("w8_matmul_expert", 14336,
         torch.ones((8, 7, 4096), dtype=torch.float32, device=dev)),
    ):
        fn = cs.kernel_fns(name)[0]
        wq = torch.zeros((8, 4096, cols), dtype=torch.int8, device=dev)
        fn(x, wq, sc, e)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for t in (512, 2048):
                fn(x[:t], wq, sc, e)
            torch.cuda.synchronize()
        names = [v.name for v in prof.events()
                 if v.device_type == torch.autograd.DeviceType.CUDA]
        print(f"[{label}] {name} device-to-host copies in 2 launches: "
              f"{sum('dtoh' in n.lower() for n in names)}; its kernels: "
              f"{sorted(set(names))}", flush=True)
        del wq
summary = {}
for r in rows:
    key = f"{r['kernel']} g{r.get('group', '-')} {r['unit']}={r['T']}"
    if r["unit"] == "S":  # one line per attention case
        key += f" B={r['batch']} {r['heads']}/{r['kv_heads']}x{r['head_dim']}"
        key += f" {r['shape']}"
    if "mode" in r:  # a probe: one line per mode and shape
        key += f" {r['mode']} {r['shape']}"
    s = summary.setdefault(key, dict(ms=0.0, bound_ms=0.0, plain_ms=0.0,
                                     library_ms=0.0, max_abs_err=0.0))
    for k in ("ms", "bound_ms", "plain_ms", "library_ms"):
        s[k] += r[k]
    s["max_abs_err"] = max(s["max_abs_err"], r["max_abs_err"])
for k, s in summary.items():
    print(f"[{label}] {k}: " + json.dumps(s), flush=True)
if out:
    with open(out, "w") as f:
        json.dump(rows, f)
'''


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", metavar="LABEL=DIR",
                        help="a tree and its label (default: C=.)")
    parser.add_argument("--order", nargs="+", default=["C"],
                        help="labels in the order of the turns")
    parser.add_argument("--out", default="")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--probes-only", action="store_true",
                        help="the probe phase alone")
    parser.add_argument("--pairs-only", action="store_true",
                        help="K5a alone, at Mixtral's and Moonlight's "
                             "expert shapes")
    parser.add_argument("--moe-steps", default="", metavar="DIR",
                        help="Mixtral's and Moonlight's int8 decode steps "
                             "at full depth, checkpoints kept in DIR")
    args = parser.parse_args(argv)
    device = pick_device(args.device)
    trees = dict(t.split("=", 1) for t in args.tree or ["C=."])
    unknown = set(args.order) - set(trees)
    if unknown:
        raise SystemExit(f"no --tree for {sorted(unknown)}")
    print(card_line(device), flush=True)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
    code = _TURN % dict(kernels=KERNELS, probes=PROBES)
    for n, label in enumerate(args.order):
        out = (str(Path(args.out).resolve() / f"turn_{n}_{label}.json")
               if args.out else "")
        run = subprocess.run(
            [sys.executable, "-c", code, label, device.type, out,
             "1" if args.probes_only else "0",
             "1" if args.pairs_only else "0",
             str(Path(args.moe_steps).resolve()) if args.moe_steps else ""],
            cwd=trees[label], capture_output=True, text=True,
        )
        for line in run.stdout.splitlines():
            if line.startswith(f"[{label}]"):
                print(line, flush=True)
        if run.returncode:
            print(run.stdout[-4000:] + run.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"turn {n} ({label}) failed: {run.returncode}")
    print(card_line(device), flush=True)


if __name__ == "__main__":
    main()
