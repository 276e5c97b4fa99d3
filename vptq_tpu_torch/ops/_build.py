"""Build and load the port's hand-written CUDA kernels.

Each ``vptq_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and
is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/vptq_tpu_torch/lib<name>.so`` at the repository root, then
loaded with ``ctypes``. No PyTorch header is included, so a build takes
seconds, not minutes. A library is rebuilt when its source, or a
header of ``csrc/`` (``lowbit.cuh``, the skeleton of K2–K4;
``lowbit_tile.cuh``, the Hopper prefill tile of K1–K4, K6a, K6b and
K7, whose mbarrier, TMA and ``wgmma`` helpers K8 takes;
``w8.cuh`` and ``w4.cuh``, the loops the MoE kernels share with K1 and
K2, and the fragment helpers K7 takes from ``w8.cuh``;
``expert_select.cuh``), is
newer (``ring_gemv.cuh`` is the asynchronous ring of the probes P1c and
P3 on ``decode_gemv.cuh``'s helpers; ``probe_gemv.cuh`` the synchronous
frame of the raw probes P1d / P1e).
Nothing is built when a module is imported: the first launch builds.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

__all__ = ["BUILD_DIR", "SOURCES", "build", "load", "nvcc_path"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "vptq_tpu_torch"
# every kernel source of the port; chip_smoke.py builds all of them
SOURCES = (
    "w8_matmul", "w4_matmul", "w2_matmul", "w3_matmul",
    "w8_matmul_expert", "w8_matmul_pairs",
    "w4_matmul_expert", "w4_matmul_pairs",
    "flash_attention", "bf16_matmul",
    "w4_probe_matmul", "w4_i32x8_matmul", "w4_raw_probe", "vq_smallk_matmul",
)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from source at first use"
        )
    return found


def _paths(name: str) -> Tuple[Path, Path]:
    return SRC_DIR / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in (src, *SRC_DIR.glob("*.cuh")))
    return newest > lib.stat().st_mtime


def build(names: Iterable[str] = SOURCES, force: bool = False
          ) -> Dict[str, Tuple[float, str]]:
    """Compile the named sources, all at once (one nvcc each).

    Returns {name: (seconds, compiler output)} for what was built.
    Raises with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        if not force and not _stale(name):
            continue
        src, lib = _paths(name)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (
            time.perf_counter(), tmp, lib,
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
        )
    done = {}
    failed = []
    for name, (t0, tmp, lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, lib)
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return done


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed.

    ``signatures`` maps each C function to (argtypes, restype).
    """
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build([name])
        lib = ctypes.CDLL(str(_paths(name)[1]))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib
