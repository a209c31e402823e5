"""Step timing and device traces of a training run (own copy of
``hig_tpu/utils/profiling.py``).

:class:`StepTimer` collects per-step wall times and dumps their
percentiles and throughput; :class:`DeviceTrace` records a
``torch.profiler`` trace (host ops, and the card's kernels on a CUDA
device) of a window of steps and writes it as a Chrome trace, which
Perfetto and ``chrome://tracing`` open.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch


class StepTimer:
    """Collects per-step wall times; dumps p50/p90/p99 + throughput."""

    def __init__(self, items_per_step: int = 0):
        self.times: list[float] = []
        self.items_per_step = items_per_step
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        out = {
            "steps": len(arr),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
            "mean_ms": float(arr.mean() * 1e3),
        }
        if self.items_per_step:
            out["items_per_sec"] = float(self.items_per_step / arr.mean())
        return out

    def dump(self, path: str) -> None:
        with open(path, "a") as f:
            f.write(json.dumps(self.summary()) + "\n")


class DeviceTrace:
    """A ``torch.profiler`` trace between :meth:`start` and :meth:`stop`,
    written to ``<log_dir>/trace.json``: host ops, and on a CUDA device
    the card's kernels and copies."""

    def __init__(self, log_dir: str, device: torch.device):
        self.log_dir = log_dir
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self.path = os.path.join(log_dir, "trace.json")

    def start(self) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof.start()

    def stop(self) -> str:
        """Stop and write the trace; returns its path."""
        self._prof.stop()
        self._prof.export_chrome_trace(self.path)
        return self.path
