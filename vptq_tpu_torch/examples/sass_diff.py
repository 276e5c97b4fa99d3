"""Compare the SASS of the port's kernels between two trees.

Builds every library of ``vptq_tpu_torch/csrc`` that a tree lacks (its
own ``ops/_build.py``, into its own ``build/``), disassembles each with
``cuobjdump -sass`` and compares the instructions of every kernel by name
(addresses, encodings and the hash of anonymous namespaces left out).
One line per library: kernels equal, kernels that differ, and kernels in
one tree only; then the names of those that differ or are new.

    python -m vptq_tpu_torch.examples.sass_diff \\
        --tree P=build/tree/parent --tree C=. [--out DIR] \\
        [--rewrite 'PATTERN=>REPLACEMENT' ...]

``--rewrite`` compares kernels whose name changed: each is a regular
expression applied to every kernel's demangled name (``cu++filt``) in
both trees, in the order given, before the names are matched; a rewrite
that gives two kernels of one tree one name fails. For example the
selection policy that the decode GEMV took as its second template
argument (``cu++filt`` numbers the template parameters in the argument
types, which then move by one), and the ids it took last:

    --rewrite '(decode_gemv<.*?), sel::Whole(,.*ScalesOf<)T6>, T5 \\*=>\\1\\2T5>, T4 *' \\
    --rewrite '(decode_gemv<.*), lowbit::Ids\\)$=>\\1)'

Needs ``nvcc`` and ``cuobjdump`` (``CUDA_HOME``, default ``/usr/local/cuda``),
and ``cu++filt`` for ``--rewrite``; exits non-zero without them. ``--out``
keeps each tree's listing.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

__all__ = ["functions", "main", "rewrite_names"]

_BUILD = ("from vptq_tpu_torch.ops import _build; "
          "_build.build(); print(' '.join(_build.SOURCES))")
# nvcc names an anonymous namespace after the file and a hash
_ANON_HASH = r"_GLOBAL__N__\w+?_cu_[0-9a-f]+"


def _tool(name: str) -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / name
    found = str(cand) if cand.exists() else shutil.which(name)
    if not found:
        raise SystemExit(f"{name} not found (set CUDA_HOME)")
    return found


def _demangle(names: list) -> list:
    """The demangled names (``cu++filt``), in order."""
    if not names:
        return []
    run = subprocess.run([_tool("cu++filt")], input="\n".join(names) + "\n",
                         capture_output=True, text=True, check=True)
    out = run.stdout.splitlines()
    if len(out) != len(names):
        raise SystemExit("cu++filt gave a name count that differs")
    return out


def rewrite_names(funcs: dict, rules: list, demangle=_demangle) -> dict:
    """``funcs`` ({mangled kernel name: instructions}, as
    ``functions(listing, keep_hash=True)`` gives them) keyed by each
    demangled name, an anonymous namespace's hash left out, after the
    ``(pattern, replacement)`` regular expressions ``rules``, in order.
    Two kernels that come to one name fail: they could not be told
    apart."""
    out = {}
    for name, demangled in zip(funcs, demangle(list(funcs))):
        demangled = re.sub(_ANON_HASH, "(anonymous namespace)", demangled)
        for pattern, repl in rules:
            demangled = re.sub(pattern, repl, demangled)
        if demangled in out:
            raise SystemExit(f"--rewrite gives two kernels the name "
                             f"{demangled}")
        out[demangled] = funcs[name]
    return out


def functions(listing: str, keep_hash: bool = False) -> dict:
    """{kernel name: its instructions} of one ``cuobjdump -sass`` listing;
    a name's anonymous-namespace hash is left out unless ``keep_hash``
    (which keeps the mangled name whole, for the demangler)."""
    out, name = {}, None
    for line in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            if not keep_hash:
                name = re.sub(_ANON_HASH, "_GLOBAL__N__", name)
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
    parser.add_argument("--rewrite", action="append", default=[],
                        metavar="PATTERN=>REPLACEMENT")
    args = parser.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    if len(trees) != 2:
        raise SystemExit("give two trees")
    rules = [tuple(r.split("=>", 1)) for r in args.rewrite]
    if any(len(r) != 2 for r in rules):
        raise SystemExit("a --rewrite is PATTERN=>REPLACEMENT")
    tool = _tool("cuobjdump")
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
            funcs = functions(listing, keep_hash=bool(rules))
            sass[label][name] = (rewrite_names(funcs, rules) if rules
                                 else funcs)
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
