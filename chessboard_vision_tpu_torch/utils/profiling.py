"""Profiling: FPS counters, per-stage latency percentiles, a device trace.

Counterpart of chessboard_vision_tpu.utils.profiling: a windowed FPS
counter and a StageTimer that collects per-stage wall times and reports
p50/p95, the BASELINE per-stage latency metric. Work on the card is
asynchronous, so a stage's time means something only when the timer waits
for the stage's output: pass ``sync``, e.g.
``StageTimer(sync=lambda _: torch.cuda.current_stream().synchronize())``.
``device_trace`` is a torch.profiler scope that writes a Chrome trace.
(The JAX package's ``aggregate_device_op_ms`` waits for the port's bench:
ROADMAP A1.)
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List

import numpy as np


@contextmanager
def device_trace(log_dir: str):
    """torch.profiler scope over the CPU and, when there is one, the card;
    on exit writes ``<log_dir>/trace.json`` (Chrome trace format) and
    yields the profiler, whose ``key_averages()`` sums time by op."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class FpsCounter:
    """Windowed FPS: update() per frame; .fps refreshes every ``window`` s."""

    def __init__(self, window: float = 1.0):
        self.window = window
        self._count = 0
        self._start = time.time()
        self.fps = 0.0

    def update(self) -> float:
        self._count += 1
        elapsed = time.time() - self._start
        if elapsed >= self.window:
            self.fps = self._count / elapsed
            self._count = 0
            self._start = time.time()
        return self.fps


class StageTimer:
    """Collects wall-time samples per named stage; reports percentiles."""

    def __init__(self, sync=None):
        self._samples: Dict[str, List[float]] = defaultdict(list)
        self._sync = sync  # called with the stage's sync_value before the clock stops

    @contextmanager
    def stage(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        yield
        if self._sync is not None and sync_value is not None:
            self._sync(sync_value)
        self._samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self._samples[name].append(seconds)

    def percentile(self, name: str, q: float) -> float:
        s = self._samples.get(name)
        return float(np.percentile(s, q)) if s else float("nan")

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, s in self._samples.items():
            arr = np.asarray(s)
            out[name] = {
                "n": len(s),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p95_ms": float(np.percentile(arr, 95) * 1e3),
                "mean_ms": float(arr.mean() * 1e3),
            }
        return out

    def reset(self):
        self._samples.clear()
