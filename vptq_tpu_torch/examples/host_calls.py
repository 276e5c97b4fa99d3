"""Host time of one K1 / K2 call at one token, on several trees, in turns.

A decode step is host-bound, so what a wrapper adds on the host shows in
tokens per second. Each turn is a fresh process in one tree (a checkout of
the repository) that times, on the host clock, 20000 back-to-back calls of
its own ``w8_matmul`` and ``w4_matmul`` at T = 1 on a small weight (256 x
4096, so that the card keeps up with the host), synchronising only at the
end, and prints the microseconds per call. The card's name and power
limit come first.

    python -m vptq_tpu_torch.examples.host_calls \\
        --tree P=build/tree/parent --tree C=. --order P C C P

Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

__all__ = ["main"]

# One turn, run with ``python -c`` from the root of its tree: argv = label
_TURN = r'''
import sys, time
import torch
from vptq_tpu_torch.ops.w4_matmul import w4_matmul
from vptq_tpu_torch.ops.w8_matmul import w8_matmul

label = sys.argv[1]
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
out_f, in_p, calls = 256, 4096, 20000
x = torch.randn((1, in_p), generator=gen, device=dev).to(torch.bfloat16)
cases = {
    "w8_matmul": (w8_matmul, torch.randint(
        -128, 128, (out_f, in_p), generator=gen, device=dev,
        dtype=torch.int8), torch.rand((2, out_f), device=dev) * 1e-2),
    "w4_matmul": (w4_matmul, torch.randint(
        -128, 128, (out_f, in_p // 2), generator=gen, device=dev,
        dtype=torch.int8), (torch.rand((in_p // 128, out_f), device=dev)
                            * 1e-2).to(torch.bfloat16)),
}
for name, (fn, wq, sc) in cases.items():
    for _ in range(200):
        fn(x, wq, sc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(x, wq, sc)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / calls * 1e6
    print(f"[{label}] {name} host us per call: {us:.2f}", flush=True)
'''


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", metavar="LABEL=DIR",
                        help="a tree and its label (default: C=.)")
    parser.add_argument("--order", nargs="+", default=["C"])
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("host_calls times calls to the card's kernels: it "
                         "needs a CUDA device")
    from vptq_tpu_torch.examples.kernel_bench import card_line

    trees = dict(t.split("=", 1) for t in args.tree or ["C=."])
    unknown = set(args.order) - set(trees)
    if unknown:
        raise SystemExit(f"no --tree for {sorted(unknown)}")
    print(card_line(torch.device("cuda")), flush=True)
    for n, label in enumerate(args.order):
        run = subprocess.run([sys.executable, "-c", _TURN, label],
                             cwd=trees[label], capture_output=True, text=True)
        print(run.stdout, end="", flush=True)
        if run.returncode:
            print(run.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"turn {n} ({label}) failed: {run.returncode}")


if __name__ == "__main__":
    main()
