"""Profiling / tracing utilities on the card.

Port of ``vptq_tpu/utils/profiling.py``:

  * :func:`trace` — a ``torch.profiler`` session (the card's kernels
    through CUPTI, and the host) that writes a Chrome trace into a
    directory.
  * :func:`device_time` — per-call device seconds of a function whose
    calls are chained: each call takes the previous one's output, so the
    calls run one after another on the card. The chain of ``n_iter``
    calls is captured once as a CUDA graph and replayed between two CUDA
    events, so the host's launch time is not in the reading (the JAX
    package loops the op inside one jit for the same reason).
  * :func:`roofline` — bandwidth / operation utilization of a measured op
    against the card's peaks.

The peaks are the H100 SXM's published figures; ``chip_smoke.py`` reads
them from here for its kernel table's bounds.
"""

from __future__ import annotations

import contextlib
import json
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

__all__ = [
    "H100_BF16_TFLOPS",
    "H100_HBM_GBPS",
    "H100_INT8_TOPS",
    "device_time",
    "roofline",
    "trace",
    "trace_kernel_names",
]

# NVIDIA H100 SXM5 80GB peaks (NVIDIA's data sheet, dense): HBM3 rate,
# bf16 tensor-core rate, int8 tensor-core rate
H100_HBM_GBPS = 3350.0
H100_BF16_TFLOPS = 989.0
H100_INT8_TOPS = 1979.0


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``with trace(dir) as d:`` → ``d/trace.json``, a Chrome trace of the
    block (the card's kernels too when CUDA is present). ``log_dir``
    defaults to a new temporary directory. CUPTI can drop the first
    kernels of a session, more in a process that has traced before: trace
    a window of many launches, not a few."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir or tempfile.mkdtemp(prefix="vptq_tpu_torch_trace_"))
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield str(out)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


def trace_kernel_names(log_dir: str) -> list:
    """Names of the card's kernels in the Chrome trace ``trace`` wrote."""
    with open(Path(log_dir) / "trace.json") as f:
        events = json.load(f).get("traceEvents", [])
    return [e["name"] for e in events if e.get("cat") == "kernel"]


def _chain(fn: Callable, args, n_iter: int) -> torch.Tensor:
    """``n_iter`` calls of ``fn``, each on the prefix of the previous
    output (reshaped and cast to the first argument's shape and dtype)."""
    x, rest = args[0], args[1:]
    for _ in range(n_iter):
        out = fn(x, *rest)
        x = out.reshape(-1)[: x.numel()].reshape(x.shape).to(x.dtype)
    return x


def device_time(
    fn: Callable, *args, n_iter: int = 50, n_time: int = 3
) -> float:
    """Per-call device seconds for ``fn(*args)``.

    ``fn``'s first argument must be a tensor whose shape and dtype its
    output can give back (the output's first elements, reshaped and cast),
    so that the calls chain and run one after another. On the card the
    chain of ``n_iter`` calls is a CUDA graph, replayed ``n_time`` times
    between CUDA events; the fastest replay over ``n_iter``. A call that
    syncs with the host or allocates in a way a graph cannot capture
    raises. Elsewhere the chain runs eagerly on the host clock.
    """
    x = args[0]
    if x.device.type != "cuda":
        _chain(fn, args, 1)  # warm
        times = []
        for _ in range(n_time):
            t0 = time.perf_counter()
            _chain(fn, args, n_iter)
            times.append(time.perf_counter() - t0)
        return min(times) / n_iter

    device = x.device
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        _chain(fn, args, 2)  # builds and loads the kernels, warms
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _chain(fn, args, n_iter)
    graph.replay()  # first replay uploads the graph
    torch.cuda.synchronize(device)
    times = []
    for _ in range(n_time):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    del graph
    return min(times) / n_iter


def roofline(
    seconds: float,
    bytes_accessed: int,
    flops: int,
    hbm_gbps: float = H100_HBM_GBPS,
    peak_tflops: float = H100_BF16_TFLOPS,
) -> Dict[str, float]:
    """Utilization report for a measured op.

    ``mxu_utilization`` keeps the JAX package's key: here it is the share
    of the tensor cores' peak (``peak_tflops``, bf16 by default)."""
    bw = bytes_accessed / seconds / 1e9
    tf = flops / seconds / 1e12
    return {
        "seconds": seconds,
        "GB_per_s": bw,
        "hbm_utilization": bw / hbm_gbps,
        "TFLOP_per_s": tf,
        "mxu_utilization": tf / peak_tflops,
        "bound": "memory"
        if (bytes_accessed / hbm_gbps) > (flops / 1e3 / peak_tflops)
        else "compute",
    }
