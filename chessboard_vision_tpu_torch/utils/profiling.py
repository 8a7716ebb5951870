"""Profiling: FPS counters, per-stage latency percentiles, a device trace
and the device time of its records by the port's module that launched them.

Counterpart of chessboard_vision_tpu.utils.profiling: a windowed FPS
counter and a StageTimer that collects per-stage wall times and reports
p50/p95, the BASELINE per-stage latency metric. Work on the card is
asynchronous, so a stage's time means something only when the timer waits
for the stage's output: pass ``sync``, e.g.
``StageTimer(sync=lambda _: torch.cuda.current_stream().synchronize())``.
``device_trace`` is a torch.profiler scope that writes a Chrome trace with
the Python stacks; ``device_op_rows`` reads its device records with the
port's frames that launched each, and ``aggregate_device_op_ms`` sums them
by stage, as the JAX function sums a TPU trace's ops by their source.
"""

from __future__ import annotations

import bisect
import json
import os
import time
import warnings
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Tuple

import numpy as np


@contextmanager
def device_trace(log_dir: str):
    """torch.profiler scope over the CPU and, when there is one, the card,
    with the Python stack of every op and launch; on exit writes
    ``<log_dir>/trace.json`` (Chrome trace format) and yields the profiler,
    whose ``key_averages()`` sums time by op."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with warnings.catch_warnings():
        # one profiling cycle: the notice that a cycle clears the last one's events does not apply
        warnings.filterwarnings("ignore", message=".*clears events", category=UserWarning)
        with profile(activities=activities, with_stack=True) as prof:
            yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


PACKAGE = "chessboard_vision_tpu_torch/"
# The trace's records of work on the device, and the host calls that
# launch or enqueue it (runtime and driver API), joined by "correlation".
DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
LAUNCH_CATEGORIES = frozenset({"cuda_runtime", "cuda_driver"})


def load_trace(trace_dir: str) -> list:
    """The events of ``<trace_dir>/trace.json``; [] when there is none."""
    path = os.path.join(trace_dir, "trace.json")
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


class PythonStacks:
    """The Python frames of a trace (its ``python_function`` spans), by
    host thread: ``port_frames(pid, tid, ts)`` gives the frames of the
    port's package that enclose the instant ``ts`` on that thread,
    innermost first, each as "<path from the package>(<line>): <name>"."""

    def __init__(self, events: list):
        spans = defaultdict(list)
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "python_function":
                spans[(e.get("pid"), e.get("tid"))].append(e)
        self._threads = {}
        for thread, evs in spans.items():
            # a span that starts with its caller and as long sorts after it
            evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0),
                                    e.get("args", {}).get("Python id", 0)))
            starts, ends, frames, parents, open_ = [], [], [], [], []
            for i, e in enumerate(evs):
                start, end = e["ts"], e["ts"] + e.get("dur", 0)
                while open_ and ends[open_[-1]] < start:
                    open_.pop()
                parents.append(open_[-1] if open_ else -1)
                name = e.get("name", "")
                cut = name.rfind(PACKAGE)
                starts.append(start)
                ends.append(end)
                frames.append(name[cut + len(PACKAGE):] if cut >= 0 else None)
                open_.append(i)
            self._threads[thread] = (starts, ends, frames, parents)

    def port_frames(self, pid, tid, ts: float) -> Tuple[str, ...]:
        spans = self._threads.get((pid, tid))
        if spans is None:
            return ()
        starts, ends, frames, parents = spans
        # The last span to start at or before ts either encloses it or lies
        # inside the innermost span that does: walk up to that one, and
        # every span above it encloses ts too.
        i = bisect.bisect_right(starts, ts) - 1
        while i >= 0 and ends[i] < ts:
            i = parents[i]
        out = []
        while i >= 0:
            if frames[i] is not None:
                out.append(frames[i])
            i = parents[i]
        return tuple(out)


def device_op_rows(trace_dir: str) -> List[Tuple[str, Tuple[str, ...], float]]:
    """(name, frames, ms) for every device record (kernel, copy, memset) of
    the trace that ``device_trace`` wrote into ``trace_dir``: ``frames``
    are the port's Python frames, innermost first, around the host call
    that launched it, found by the record's ``correlation``; () where that
    call is not in the trace or no frame of the port encloses it."""
    events = load_trace(trace_dir)
    stacks = PythonStacks(events)
    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATEGORIES:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = e
    rows = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        call = launch.get(e.get("args", {}).get("correlation"))
        frames = (stacks.port_frames(call.get("pid"), call.get("tid"), call["ts"])
                  if call is not None else ())
        rows.append((e.get("name", "?"), frames, e.get("dur", 0) / 1e3))
    return rows


def frame_path(frame: str) -> str:
    """A frame's file: "ops/hough_conv.py" of "ops/hough_conv.py(431): f"."""
    return frame.rsplit("(", 1)[0]


def stage_of_frames(frames: Tuple[str, ...], stage_of: Dict[str, str]) -> str:
    """The stage of the innermost of ``frames`` whose path ends with a key
    of ``stage_of`` (a frame without a key passes the record to its
    caller); "other" where none has one."""
    return next((name for path in map(frame_path, frames)
                 for suffix, name in stage_of.items() if path.endswith(suffix)), "other")


def aggregate_device_op_ms(
    trace_dir: str,
    stage_of: Dict[str, str] = None,
    per: int = 1,
    exclude_sources: tuple = (),
) -> Dict[str, float]:
    """Device time of a ``device_trace`` window by stage: each device
    record goes to the stage of the innermost port frame around its launch
    whose path ends with a key of ``stage_of`` (a frame without a key
    passes it to its caller, so a helper such as ops/xla_rounding.py counts
    for the module that called it), and to "other" where no frame has one
    or the launch is not in the trace. ``per`` divides the totals (e.g. the
    steps in the window); ``exclude_sources`` drops records whose innermost
    port frame ends with one of the suffixes. The stages and the dropped
    records sum to the window's device time. {stage: ms} rounded to 4
    places, largest first; {} for a trace without device records, as on
    the CPU."""
    stage_of = stage_of or {}
    tot: Dict[str, float] = defaultdict(float)
    for _, frames, ms in device_op_rows(trace_dir):
        if frames and frame_path(frames[0]).endswith(tuple(exclude_sources)):
            continue
        tot[stage_of_frames(frames, stage_of)] += ms
    return {
        k: round(v / per, 4)
        for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
    }


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
