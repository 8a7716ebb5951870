"""A traced stretch of session calls, and the arithmetic that reads it.

The profiler scope, the sleep pads and the attribution of each device record
to the port's module that launched it are copied from
chessboard_vision_tpu_torch/utils/profiling.py and tools/bench.py at commit
9f9af32 (``device_trace``, ``sleep_pads``, ``PythonStacks``,
``device_op_rows``, ``stage_of_frames``, ``STAGE_OF``, ``LAUNCH_CALLS``): a
record goes to the stage of the innermost frame of the port around the host
call that launched it (joined by ``correlation``), the pads left out.

A stretch is a run of session calls, each inside a ``bench.call`` range
(``torch.profiler.record_function``), after ``PAD_LAUNCHES`` sleep kernels:
torch.profiler loses the device records of a session's first launches. Its
window runs from the first call's start to the last call's end on the
trace's own clock; ``read`` turns it into a ``Stretch``.
"""

from __future__ import annotations

import bisect
import json
import warnings
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Tuple

PACKAGE = "chessboard_vision_tpu_torch/"
CALL_RANGE = "bench.call"
DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
LAUNCH_CATEGORIES = frozenset({"cuda_runtime", "cuda_driver"})
# Host calls that each put work on the device; a CUDA graph launch counts once.
LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                          "cudaGraphLaunch", "cuGraphLaunch"})
PAD_LAUNCHES = 32

# The port's modules by stage: tools/bench.py's STAGE_OF.
STAGE_OF = {
    "ops/matmul_resample.py": "warp_extract",
    "ops/warp.py": "warp_extract",
    "ops/layout.py": "warp_extract",
    "ops/filters.py": "preprocess",
    "ops/color.py": "color",
    "ops/canny.py": "hough",
    "ops/hough_conv.py": "hough",
    "ops/hough.py": "hough",
    "kernels/score_matmul.py": "hough",
    "ops/piece.py": "piece_cascade",
    "models/piece_detector.py": "piece_cascade",
    "ops/change.py": "change_model",
    "ops/fsm.py": "fsm",
    "models/enhancer.py": "enhance",
    "ops/enhance.py": "enhance",
    "kernels/bilateral.py": "enhance",
    "kernels/clahe.py": "enhance",
    "models/pipeline.py": "upload",
}
KERNEL_SITES = "kernels/"  # the port's hand-written kernels, a call site a file
B1_SITE = "kernels/score_matmul.py"  # the port's score-matmul call site, whatever runs under it


@contextmanager
def device_trace(path: str, with_stack: bool):
    """torch.profiler over the CPU and the card; writes a Chrome trace to
    ``path`` on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*clears events", category=UserWarning)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     with_stack=with_stack) as prof:
            yield prof
    prof.export_chrome_trace(path)


def sleep_pads():
    import torch

    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(1)


class PythonStacks:
    """The Python frames of a trace by host thread: ``frames(pid, tid, ts)``
    gives the frames that enclose the instant ``ts``, innermost first, each
    as its name in the trace ("<file>(<line>): <function>")."""

    def __init__(self, events: list):
        spans = defaultdict(list)
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "python_function":
                spans[(e.get("pid"), e.get("tid"))].append(e)
        self._threads = {}
        for thread, evs in spans.items():
            evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0),
                                    e.get("args", {}).get("Python id", 0)))
            starts, ends, names, parents, open_ = [], [], [], [], []
            for i, e in enumerate(evs):
                start, end = e["ts"], e["ts"] + e.get("dur", 0)
                while open_ and ends[open_[-1]] < start:
                    open_.pop()
                parents.append(open_[-1] if open_ else -1)
                starts.append(start)
                ends.append(end)
                names.append(e.get("name", ""))
                open_.append(i)
            self._threads[thread] = (starts, ends, names, parents)

    def frames(self, pid, tid, ts: float) -> Tuple[str, ...]:
        spans = self._threads.get((pid, tid))
        if spans is None:
            return ()
        starts, ends, names, parents = spans
        i = bisect.bisect_right(starts, ts) - 1
        while i >= 0 and ends[i] < ts:
            i = parents[i]
        out = []
        while i >= 0:
            out.append(names[i])
            i = parents[i]
        return tuple(out)


def port_path(frame: str) -> str:
    """The port file of a frame, from the package on ("ops/canny.py"); "" if
    the frame is not the port's."""
    cut = frame.rfind(PACKAGE)
    return frame[cut + len(PACKAGE):].rsplit("(", 1)[0] if cut >= 0 else ""


def kernel_sites(frames: Tuple[str, ...]) -> set:
    """The port's kernel call sites (``kernels/<file>.py``) among the frames."""
    paths = {port_path(f) for f in frames}
    return {p for p in paths if p.startswith(KERNEL_SITES) and "/" not in p[len(KERNEL_SITES):]}


def stage_of_frames(frames: Tuple[str, ...]) -> str:
    """The stage of the innermost port frame whose file has one; "other"."""
    for f in frames:
        path = port_path(f)
        for suffix, name in STAGE_OF.items():
            if path and path.endswith(suffix):
                return name
    return "other"


def host_label(frames: Tuple[str, ...]) -> str:
    """What the host was doing: the innermost frame of the port or of the
    benchmark, as "<file>: <function>"; "idle" outside any."""
    for f in frames:
        for mark in (PACKAGE, "benchmark/"):
            cut = f.rfind(mark)
            if cut >= 0:
                path, _, func = f[cut:].partition(": ")
                return f"{path.rsplit('(', 1)[0]}: {func}"
    return "idle"


class Stretch(NamedTuple):
    calls: int
    window_s: float  # first call's start to last call's end
    busy_s: float  # the union of the device records inside the window
    launches: int  # host launch calls inside the window's calls
    records: int  # device records of those launches that the trace kept
    device_ops: List[Tuple[str, float]]  # seconds by record name, largest first
    stage_s: Dict[str, float]  # seconds by stage (with stacks; else {})
    b1_s: float  # seconds of records launched under the score-matmul call site: site_s[B1_SITE]
    idle_gaps: List[Tuple[str, float]]  # idle seconds by what the host did (with stacks)
    site_s: Dict[str, float]  # seconds of records launched under each kernel call site (stacks)


def _union(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def read(path: str) -> Stretch:
    """A stretch's numbers from the trace at ``path`` (microseconds in the
    trace, seconds out)."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    calls = sorted((e for e in events if e.get("ph") == "X" and e.get("name") == CALL_RANGE
                    and e.get("cat") == "user_annotation"), key=lambda e: e["ts"])
    if not calls:
        raise ValueError(f"{path}: no {CALL_RANGE} range in the trace")
    t0, t1 = calls[0]["ts"], max(e["ts"] + e["dur"] for e in calls)
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in calls]
    starts = [s for s, _ in spans]

    def in_call(ts: float) -> bool:
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= spans[i][1]

    launch = {}
    n_launch = 0
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATEGORIES:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = e
            if e.get("name") in LAUNCH_CALLS and in_call(e["ts"]):
                n_launch += 1
    stacks = PythonStacks(events)
    with_stack = bool(stacks._threads)
    recs, kept = [], 0
    ops, stages, sites = defaultdict(float), defaultdict(float), defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        call = launch.get(e.get("args", {}).get("correlation"))
        if call is None or not in_call(call["ts"]):
            continue  # the pads' records, and work launched outside the calls
        kept += call.get("name") in LAUNCH_CALLS
        s, d = e["ts"], e.get("dur", 0)
        recs.append((s, s + d))
        ops[e.get("name", "?")] += d / 1e6
        if with_stack:
            frames = stacks.frames(call.get("pid"), call.get("tid"), call["ts"])
            stages[stage_of_frames(frames)] += d / 1e6
            for site in kernel_sites(frames):
                sites[site] += d / 1e6
    clipped = [(max(s, t0), min(e, t1)) for s, e in recs if e > t0 and s < t1]
    gaps = defaultdict(float)
    if with_stack:
        host = calls[0].get("pid"), calls[0].get("tid")
        end = t0
        for s, e in sorted(clipped) + [(t1, t1)]:
            if s > end:
                gaps[host_label(stacks.frames(*host, (s + end) / 2))] += (s - end) / 1e6
            end = max(end, e)
    return Stretch(
        calls=len(calls), window_s=(t1 - t0) / 1e6, busy_s=_union(clipped) / 1e6,
        launches=n_launch, records=kept,
        device_ops=sorted(ops.items(), key=lambda kv: -kv[1]),
        stage_s=dict(sorted(stages.items(), key=lambda kv: -kv[1])),
        b1_s=sites.get(B1_SITE, 0.0), idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1]),
        site_s=dict(sites),
    )
