"""The hall's span metrics (spans.py and its five readers) on a synthetic
Record over a filled call table: the means over the window's calls, and
None where calls are missing or do not line up; then on a short run of a
small hall on the CPU."""

import time

import numpy as np
import pytest

from benchmark import run, spans
from benchmark.tests import tiny
from chessboard_vision_tpu_torch.utils import profiling as tprof

READERS = ("upload_host_ms.hall", "enqueue_host_ms.hall", "device_wait_ms.hall",
           "rules_host_ms.hall", "h2d_mb_per_tick.hall")
SPANS = {"upload_host_ms.hall": ("pipeline.upload",),
         "enqueue_host_ms.hall": ("pipeline.enqueue",),
         "device_wait_ms.hall": ("session.device_wait",),
         "rules_host_ms.hall": ("session.smart_scan", "session.rules")}


class Stretch:
    def __init__(self, calls):
        self.calls = calls


def record(call_s, stretches=()) -> run.Record:
    return run.Record(window_s=1.0, setup_s=0.0, latency_s=np.zeros(0), frames_done=0,
                      wait_s=np.zeros(0), call_s=np.asarray(call_s, np.float64),
                      step_s=np.zeros(len(call_s)), stretches=list(stretches),
                      b1_shape=(1, 1, 1), config={})


@pytest.fixture(autouse=True)
def empty_table():
    tprof.clear()
    yield
    tprof.clear()


def tick(k: int):
    """One tick of a hall's spans; the smart scan skipped on every third."""
    with tprof.span("session.on_frames"):
        if k % 3:
            with tprof.span("session.smart_scan"):
                pass
        with tprof.span("pipeline.step"):
            with tprof.span("pipeline.upload"):
                tprof.count("pipeline.h2d_bytes", 1_000_000 * (k + 1))
            with tprof.span("pipeline.enqueue"):
                pass
        for name in ("session.device_wait", "session.rules"):
            with tprof.span(name):
                pass


def test_the_readers_give_the_window_means():
    with tprof.span("pipeline.upload"):  # a call before the window (the reference capture)
        pass
    for k in range(10):  # 3 warm-up ticks, 5 timed, 2 traced
        tick(k)
    calls = tprof.recorded_calls()
    window = calls[4:9]
    r = record([1.0] * 5, [Stretch(1), Stretch(1)])
    assert spans.window(r) == window
    for name in READERS:
        got = run.metric_reader(name)(r)
        if name == "h2d_mb_per_tick.hall":
            want = np.mean([4, 5, 6, 7, 8])
        else:
            want = np.mean([sum(c.ms(s) for s in SPANS[name]) for c in window])
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("case", ["too_few_calls", "longer_than_the_wall", "no_calls",
                                  "no_table"])
def test_the_readers_give_none_where_calls_miss_or_do_not_line_up(case, monkeypatch):
    for k in range(6):
        tick(k)
    if case == "no_table":  # a program that keeps no call table
        monkeypatch.delattr(tprof, "recorded_calls")
        r = record([1.0] * 4)
    elif case == "too_few_calls":
        r = record([1.0] * 5, [Stretch(2)])
    elif case == "longer_than_the_wall":
        r = record([1.0, 1.0, 1e-9, 1.0], [Stretch(1)])
    else:
        r = record([])
    assert spans.window(r) is None
    assert all(run.metric_reader(name)(r) is None for name in READERS)


def test_a_span_no_call_holds_reads_none():
    for k in range(4):
        with tprof.span("session.on_frames"):
            pass
    r = record([1.0] * 4)
    assert len(spans.window(r)) == 4
    assert all(run.metric_reader(name)(r) is None for name in READERS)


def test_a_small_hall_on_the_cpu():
    """A short run of a 2-board hall at 320x240: the window lines up, the
    span readers read it, and no bytes count, since on the CPU nothing goes
    to a card."""
    cell = tiny.hall()
    _, r = run.run_cell(cell, tiny.SEED, 3.0, False, device="cpu", t_start=time.perf_counter())
    calls = spans.window(r)
    assert calls is not None and len(calls) == len(r.call_s)
    assert run.metric_reader("h2d_mb_per_tick.hall")(r) is None
    for name in READERS[:4]:
        assert run.metric_reader(name)(r) > 0
    step = np.mean([c.ms("pipeline.step") for c in calls])
    assert step <= np.mean(r.step_s) * 1e3  # the span lies inside the wrapper that times step_s
