"""Profiling: spans and counters of the port's calls, FPS counters, a
device trace and the device time of its records by the port's module that
launched them.

The call table: ``span(name)`` marks a layer boundary (a session call, the
pipeline's step, its upload and enqueue, the wait for the card, the rules)
and ``count(name, n)`` counts work at one (the bytes a call uploads). A span
opened with no span open on its thread opens a *call* (one frame, one
tick), and every span and count inside it belongs to that call. Recording
is always on: a thread gathers its open call's spans in a list, and the
call, once its first span closes, joins a deque of the newest ``CALLS``
calls; ``recorded_calls()`` reads them, each call as its spans' total and
self time by name and its counters. While a torch.profiler session records,
a span also enters ``torch.profiler.record_function``, so it lands in the
Chrome trace as a ``user_annotation`` range on the clock of the device
records it launched; without one it costs no profiler call.

Counterpart of chessboard_vision_tpu.utils.profiling for the rest: a
windowed FPS counter; ``device_trace`` is a torch.profiler scope that
writes a Chrome trace with the Python stacks; ``device_op_rows`` reads its
device records with the port's frames that launched each, and
``aggregate_device_op_ms`` sums them by stage, as the JAX function sums a
TPU trace's ops by their source; ``span_rows`` gives each span's host,
self and device-idle time in such a trace.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
import warnings
from collections import defaultdict, deque
from contextlib import contextmanager
from types import MappingProxyType
from typing import Dict, List, Mapping, NamedTuple, Tuple

import torch.autograd.profiler as autograd_profiler
from torch.profiler import record_function

# -- the call table -----------------------------------------------------------

CALLS = 8192  # the calls the table keeps, the newest


class _Thread(threading.local):
    open = None  # the innermost open span on this thread
    spans: list  # the spans of the call open on this thread, in the order opened
    counts: dict  # its counters


_thread = _Thread()
_calls: deque = deque(maxlen=CALLS)  # finished calls, (spans, counts), oldest first


class span:
    """``with span(name):`` one span of the call open on this thread, or the
    first of a new call when no span is open on it. The span is its own
    entry in the call: name, parent span, start and end on
    ``time.perf_counter_ns``. Under a recording torch.profiler session it is
    also a ``record_function`` range."""

    __slots__ = ("name", "parent", "start", "end", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        th = _thread
        parent = self.parent = th.open
        if parent is None:
            th.spans, th.counts = [self], {}
        else:
            th.spans.append(self)
        th.open = self
        if autograd_profiler._is_profiler_enabled:
            self._range = record_function(self.name)
            self._range.__enter__()
        else:
            self._range = None
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        th = _thread
        th.open = self.parent
        if self.parent is None:
            _calls.append((th.spans, th.counts))
        return False


def count(name: str, n: int):
    """Add ``n`` to the counter ``name`` of the call open on this thread;
    outside any call, nothing."""
    th = _thread
    if th.open is not None:
        th.counts[name] = th.counts.get(name, 0) + n


class SpanTotal(NamedTuple):
    n: int  # spans of the name in the call
    total_ns: int  # their durations, summed
    self_ns: int  # the same less the durations of their child spans


class CallRecord(NamedTuple):
    """One call of the table: the span that opened it, and its spans and
    counters by name (read-only mappings)."""

    root: str
    spans: Mapping[str, SpanTotal]
    counts: Mapping[str, int]

    def ms(self, name: str) -> float:
        """The summed duration of the call's spans ``name``, ms (0 without one)."""
        s = self.spans.get(name)
        return 0.0 if s is None else s.total_ns / 1e6


def recorded_calls() -> Tuple[CallRecord, ...]:
    """The newest ``CALLS`` finished calls, oldest first."""
    out = []
    for spans, counts in tuple(_calls):
        child_ns: Dict[int, int] = defaultdict(int)  # by id() of the parent span
        for s in spans:
            if s.parent is not None:
                child_ns[id(s.parent)] += s.end - s.start
        totals: Dict[str, list] = {}
        for s in spans:
            t = totals.setdefault(s.name, [0, 0, 0])
            t[0] += 1
            t[1] += s.end - s.start
            t[2] += s.end - s.start - child_ns.get(id(s), 0)
        out.append(CallRecord(spans[0].name,
                              MappingProxyType({k: SpanTotal(*v) for k, v in totals.items()}),
                              MappingProxyType(dict(counts))))
    return tuple(out)


def clear():
    """Empty the table (for tests), and end any call open on this thread."""
    _calls.clear()
    _thread.open = None


# -- device traces ------------------------------------------------------------


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
# The runtime calls that each put one record on the device: kernel
# launches, async copies and memsets.
LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync"})

# Sleep kernels launched at the start of a profiled window. A
# torch.profiler session loses the device records of its first launches,
# inside kineto/CUPTI (the Chrome trace lacks them as the events do): 0-8
# a session mostly, now and then dozens. The pads take the usual loss; the
# losses never fell at a session's end.
PAD_LAUNCHES = 32


def sleep_pads():
    """Launch the PAD_LAUNCHES sleep kernels that start a profiled window."""
    import torch

    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(1)


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


class SpanRow(NamedTuple):
    n: int  # ranges of the span's name in the trace
    ms: float  # their host time
    self_ms: float  # less the time of the ranges nested in them
    idle_ms: float  # the time inside them with no device record running


def span_rows(trace_dir: str, per: int = 1) -> Dict[str, SpanRow]:
    """Each span of the trace that ``device_trace`` wrote into
    ``trace_dir`` (its ``user_annotation`` ranges, by name): host, self and
    device-idle time, each divided by ``per`` (e.g. the steps in the
    window). Idle time is the range's time in which no device record
    (kernel, copy, memset) ran: what the host was doing while the card
    waited. {name: SpanRow}, in order of first appearance."""
    events = load_trace(trace_dir)
    ranges = defaultdict(list)
    busy = []
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") == "user_annotation":
            ranges[(e.get("pid"), e.get("tid"))].append(e)
        elif e.get("cat") in DEVICE_CATEGORIES:
            busy.append((e["ts"], e["ts"] + e.get("dur", 0)))
    merged = []  # the device's busy time, disjoint intervals in order
    for s, e in sorted(busy):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [s for s, _ in merged]

    def busy_in(s: float, e: float) -> float:
        k, total = max(0, bisect.bisect_right(starts, s) - 1), 0.0
        while k < len(merged) and merged[k][0] < e:
            total += max(0.0, min(e, merged[k][1]) - max(s, merged[k][0]))
            k += 1
        return total

    rows: Dict[str, list] = {}
    for evs in ranges.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        open_: list = []  # [end, entry of its name's row]
        for e in evs:
            s, d = e["ts"], e.get("dur", 0)
            while open_ and open_[-1][0] <= s:
                open_.pop()
            row = rows.setdefault(e.get("name", "?"), [0, 0.0, 0.0, 0.0])
            row[0] += 1
            row[1] += d
            row[2] += d
            row[3] += d - busy_in(s, s + d)
            if open_:
                open_[-1][1][2] -= d  # the parent's self time
            open_.append([s + d, row])
    return {k: SpanRow(n, ms / 1e3 / per, self_ms / 1e3 / per, idle / 1e3 / per)
            for k, (n, ms, self_ms, idle) in rows.items()}


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
