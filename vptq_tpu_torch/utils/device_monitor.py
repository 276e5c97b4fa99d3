"""Device memory telemetry for the web app.

Port of ``vptq_tpu/utils/device_monitor.py``: the same rolling window of
100 samples under the same keys, read from one explicit device. On CUDA,
``bytes_in_use`` and ``peak_bytes`` are the caching allocator's current
and peak allocated bytes and ``bytes_limit`` the card's total memory,
read once when the monitor is made; on the CPU every reading is 0.

The poll runs on its own thread while a request's thread may be
capturing a decode CUDA graph in the global capture mode, where a CUDA
runtime call from another thread (``torch.cuda.mem_get_info`` among
them) invalidates the capture. So the poll reads only
``torch.cuda.memory_stats``: the allocator's host-side counters.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List

import torch

__all__ = ["DeviceMonitor"]

_MAX_SAMPLES = 100


class DeviceMonitor:
    def __init__(self, device, poll_interval: float = 1.0):
        device = torch.device(device)
        self.bytes_limit = 0
        if device.type == "cuda":
            # the index fixed here: the poll asks the runtime for nothing
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self.bytes_limit = torch.cuda.get_device_properties(
                device).total_memory
        self.device = device
        self.poll_interval = poll_interval
        self.samples: Dict[str, collections.deque] = {
            "time": collections.deque(maxlen=_MAX_SAMPLES),
            "bytes_in_use": collections.deque(maxlen=_MAX_SAMPLES),
            "bytes_limit": collections.deque(maxlen=_MAX_SAMPLES),
            "peak_bytes": collections.deque(maxlen=_MAX_SAMPLES),
        }
        # one sample's four values are appended and read together
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    def snapshot(self) -> Dict[str, int]:
        if self.device.type != "cuda":
            return {"bytes_in_use": 0, "bytes_limit": 0, "peak_bytes": 0}
        s = torch.cuda.memory_stats(self.device)
        return {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "bytes_limit": self.bytes_limit,
            "peak_bytes": s.get("allocated_bytes.all.peak", 0),
        }

    def _poll(self):
        while not self._stop.is_set():
            s = dict(self.snapshot(), time=time.time())
            with self._lock:
                for k, v in self.samples.items():
                    v.append(s[k])
            self._stop.wait(self.poll_interval)

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._poll, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def series(self) -> Dict[str, List[float]]:
        with self._lock:
            return {k: list(v) for k, v in self.samples.items()}
