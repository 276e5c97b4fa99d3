"""Compare the SASS of the port's kernels between two trees.

Builds every library of ``vptq_tpu_torch/csrc`` that a tree lacks (its
own ``ops/_build.py``, into its own ``build/``), disassembles each with
``cuobjdump -sass`` and compares the instructions of every kernel by name
(addresses, encodings and the hash of anonymous namespaces left out).
One line per library: kernels equal, kernels that differ, and kernels in
one tree only; then the names of those that differ or are new.

    python -m vptq_tpu_torch.examples.sass_diff \\
        --tree P=build/tree/parent --tree C=. [--out DIR]

Needs ``nvcc`` and ``cuobjdump`` (``CUDA_HOME``, default ``/usr/local/cuda``);
exits non-zero without them. ``--out`` keeps each tree's listing.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

__all__ = ["functions", "main"]

_BUILD = ("from vptq_tpu_torch.ops import _build; "
          "_build.build(); print(' '.join(_build.SOURCES))")


def _cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "cuobjdump"
    found = str(cand) if cand.exists() else shutil.which("cuobjdump")
    if not found:
        raise SystemExit("cuobjdump not found (set CUDA_HOME)")
    return found


def functions(listing: str) -> dict:
    """{kernel name: its instructions} of one ``cuobjdump -sass`` listing;
    a name's anonymous-namespace hash is left out."""
    out, name = {}, None
    for line in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            # nvcc names an anonymous namespace after the file and a hash
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "_GLOBAL__N__",
                          m.group(1))
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;?\s*/\*", line)
        if name and m:
            out[name].append(m.group(1))
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", action="append", required=True,
                        metavar="LABEL=DIR")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    if len(trees) != 2:
        raise SystemExit("give two trees")
    tool = _cuobjdump()
    sass = {}
    for label, root in trees.items():
        run = subprocess.run([sys.executable, "-c", _BUILD], cwd=root,
                             capture_output=True, text=True)
        if run.returncode:
            print(run.stdout[-4000:] + run.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"build of {label} failed")
        sass[label] = {}
        for name in run.stdout.split():
            lib = Path(root) / "build" / "vptq_tpu_torch" / f"lib{name}.so"
            listing = subprocess.run([tool, "-sass", str(lib)], check=True,
                                     capture_output=True, text=True).stdout
            if args.out:
                Path(args.out).mkdir(parents=True, exist_ok=True)
                (Path(args.out) / f"{label}_{name}.sass").write_text(listing)
            sass[label][name] = functions(listing)
    a, b = trees
    for name in sorted(set(sass[a]) | set(sass[b])):
        fa, fb = sass[a].get(name, {}), sass[b].get(name, {})
        same = [k for k in fa if k in fb and fa[k] == fb[k]]
        differ = [k for k in fa if k in fb and fa[k] != fb[k]]
        only_a = [k for k in fa if k not in fb]
        only_b = [k for k in fb if k not in fa]
        print(f"{name}: {len(same)} equal, {len(differ)} differ, "
              f"{len(only_a)} only in {a}, {len(only_b)} only in {b}")
        for k in differ:
            print(f"  differs: {k} ({len(fa[k])} / {len(fb[k])} instructions)")
        for k in only_a:
            print(f"  only in {a}: {k}")
        for k in only_b:
            print(f"  only in {b}: {k}")


if __name__ == "__main__":
    main()
