"""The port's call table (utils/profiling.py: ``span``, ``count``,
``recorded_calls``) and the spans at the sessions' and the pipeline's layer
boundaries, on the CPU.

A span opened with no span open on its thread opens a call; its spans nest,
and a span's self time is its duration less its children's. The table keeps
the newest calls whose entries it still holds. One ``GameSession.on_frame``
and one 3-board ``MultiStreamSession.on_frames`` each record one call with
the spans of their layers; the bytes an upload sends to a device count in
``pipeline.h2d_bytes`` (none on the CPU). Under a torch.profiler
session every span is also a ``user_annotation`` range of the Chrome trace,
nested as in the table; with no profiler, ``record_function`` is never
entered. ``span_rows`` reads host, self and device-idle time from a trace.
"""

import json
from collections import Counter

import numpy as np
import pytest
import torch

from chessboard_vision_tpu_torch.geometry import BoardGeometry
from chessboard_vision_tpu_torch.models.pipeline import to_device, upload
from chessboard_vision_tpu_torch.parallel.session import MultiStreamSession
from chessboard_vision_tpu_torch.session.game_session import GameSession
from chessboard_vision_tpu_torch.tools.synth import SynthCamera, bench_corners, initial_occupancy
from chessboard_vision_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

H, W = 240, 320
FLAGS = 66  # a board's uploaded flags: 64 square-mask bits, given, refresh

# Each span of a session call, with the span it nests in.
SESSION_PARENTS = {
    "session.smart_scan": "root",
    "pipeline.step": "root",
    "pipeline.upload": "pipeline.step",
    "pipeline.enqueue": "pipeline.step",
    "session.device_wait": "root",
    "session.rules": "root",
}


@pytest.fixture(autouse=True)
def empty_table():
    """Worker processes run many tests: each starts with an empty table."""
    tprof.clear()
    yield
    tprof.clear()


def spin(ns: int):
    from time import perf_counter_ns

    end = perf_counter_ns() + ns
    while perf_counter_ns() < end:
        pass


def test_spans_nest_and_self_times_add_up():
    tprof.count("outside", 7)  # no call open: nothing recorded
    with tprof.span("root"):
        spin(200_000)
        with tprof.span("a"):
            spin(100_000)
        with tprof.span("b"):
            with tprof.span("c"):
                spin(100_000)
            tprof.count("bytes", 5)
        with tprof.span("a"):
            tprof.count("bytes", 3)
    with tprof.span("next"):
        pass
    calls = tprof.recorded_calls()
    assert [c.root for c in calls] == ["root", "next"]
    call = calls[0]
    s = call.spans
    assert set(s) == {"root", "a", "b", "c"} and s["a"].n == 2 and s["root"].n == 1
    assert all(v.self_ns >= 0 for v in s.values())
    assert s["root"].self_ns + s["a"].total_ns + s["b"].total_ns == s["root"].total_ns
    assert s["b"].self_ns + s["c"].total_ns == s["b"].total_ns
    assert s["c"].self_ns == s["c"].total_ns >= 100_000
    assert s["root"].self_ns >= 200_000
    assert dict(call.counts) == {"bytes": 8} and dict(calls[1].counts) == {}
    assert call.ms("c") == s["c"].total_ns / 1e6 and call.ms("missing") == 0.0
    with pytest.raises(TypeError):
        call.spans["x"] = s["a"]  # a read-only view


@pytest.mark.parametrize("spans_a_call", [1, 40], ids=["calls_past_capacity",
                                                       "many_spans_a_call"])
def test_the_table_drops_the_oldest_calls(spans_a_call):
    """Past CALLS calls the oldest go, whole, however many spans a call has."""
    made = tprof.CALLS + 5
    for k in range(made):
        with tprof.span("call"):
            tprof.count("k", k)
            for _ in range(spans_a_call - 1):
                with tprof.span("inner"):
                    pass
    calls = tprof.recorded_calls()
    assert [c.counts["k"] for c in calls] == list(range(5, made))
    assert all(c.spans["call"].n == 1 and c.spans.get("inner", (0,))[0] == spans_a_call - 1
               for c in calls)


def _camera():
    corners = bench_corners(H, W)
    g = BoardGeometry.from_calibration(corners, display_size=(W, H))
    frame = SynthCamera(corners, frame_size=(H, W), board_px=g.board_size).render(
        initial_occupancy(), np.random.default_rng(0))
    return corners, g, frame


def _one_call(which: str):
    """A session on the CPU, its reference captured, and one call of it
    made on a cleared table: the call's root span."""
    corners, g, frame = _camera()
    if which == "player":
        s = GameSession(device="cpu")
        s.on_calibration_requested(config={"corners": corners.tolist(), "display_size": [W, H]})
        s.capture_reference_frame(frame)
        tprof.clear()
        s.on_frame(frame)
        return "session.on_frame"
    frames = np.stack([frame] * 3)
    s = MultiStreamSession(g, 3, device="cpu")
    s.capture_reference(frames)
    tprof.clear()
    s.on_frames(frames)
    return "session.on_frames"


@pytest.mark.parametrize("which", ["player", "hall"])
def test_a_session_call_records_one_call(which):
    root = _one_call(which)
    (call,) = tprof.recorded_calls()
    assert call.root == root and set(call.spans) == {root, *SESSION_PARENTS}
    assert all(v.n == 1 for v in call.spans.values())
    assert dict(call.counts) == {}  # on the CPU nothing goes to a card
    s = call.spans
    step = s["pipeline.step"]
    assert step.self_ns + s["pipeline.upload"].total_ns + s["pipeline.enqueue"].total_ns \
        == step.total_ns
    children = sum(v.total_ns for k, v in s.items() if SESSION_PARENTS.get(k) == "root")
    assert s[root].self_ns + children == s[root].total_ns


def test_h2d_bytes_count_what_goes_to_a_device():
    """An upload's buffer (frames and flags) and a host tensor moved by
    ``to_device`` count when their device is not the CPU (the "meta" device
    stands in for the card here); on the CPU nothing counts."""
    frames = np.arange(3 * H * W * 3, dtype=np.uint32).astype(np.uint8).reshape(3, H, W, 3)
    flags = np.ones((3, FLAGS), bool)
    with tprof.span("call"):
        for device in (torch.device("meta"), torch.device("cpu")):
            up, up_flags = upload(frames, flags, device)
            moved = to_device(torch.from_numpy(frames), device)
            assert up.shape == moved.shape == frames.shape and up_flags.shape == flags.shape
    (call,) = tprof.recorded_calls()
    assert dict(call.counts) == {"pipeline.h2d_bytes": 2 * frames.nbytes + flags.size}
    assert call.spans["pipeline.upload"].n == 2


def _innermost_parents(ranges: list) -> list:
    """(name, name of the innermost range enclosing it or "root") of each
    range of one thread."""
    ranges = sorted(ranges, key=lambda e: (e["ts"], -e["dur"]))
    out, open_ = [], []
    for e in ranges:
        while open_ and open_[-1]["ts"] + open_[-1]["dur"] <= e["ts"]:
            open_.pop()
        out.append((e["name"], open_[-1]["name"] if open_ else "root"))
        open_.append(e)
    return out


def test_spans_are_user_annotation_ranges_under_the_profiler(tmp_path):
    corners, g, frame = _camera()
    s = GameSession(device="cpu")
    s.on_calibration_requested(config={"corners": corners.tolist(), "display_size": [W, H]})
    s.capture_reference_frame(frame)
    tprof.clear()
    with tprof.device_trace(str(tmp_path)):
        s.on_frame(frame)
    (call,) = tprof.recorded_calls()
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    ranges = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    assert Counter(e["name"] for e in ranges) == {k: v.n for k, v in call.spans.items()}
    parents = dict(_innermost_parents(ranges))
    assert parents == {"session.on_frame": "root",
                       **{k: "session.on_frame" if p == "root" else p
                          for k, p in SESSION_PARENTS.items()}}
    rows = tprof.span_rows(str(tmp_path))
    assert {k: r.n for k, r in rows.items()} == {k: v.n for k, v in call.spans.items()}
    for r in rows.values():
        assert 0 <= r.self_ms <= r.ms and r.idle_ms == pytest.approx(r.ms)  # no device here


def test_no_profiler_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(tprof, "record_function", refuse)
    with tprof.span("root"):
        with tprof.span("child"):
            tprof.count("n", 1)
    _one_call("hall")
    assert [c.root for c in tprof.recorded_calls()] == ["session.on_frames"]


def test_span_rows_put_device_idle_inside_each_range(tmp_path):
    """A synthetic trace: a step range holding an upload and an enqueue
    range, and device records that cover part of each."""
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1,
                "tid": 1 if cat == "user_annotation" else 7}

    events = [
        x("user_annotation", "pipeline.step", 0, 1000),
        x("user_annotation", "pipeline.upload", 0, 400),
        x("user_annotation", "pipeline.enqueue", 400, 500),
        x("user_annotation", "pipeline.step", 2000, 1000),
        x("gpu_memcpy", "Memcpy HtoD", 300, 200),  # 100 in upload, 100 in enqueue
        x("kernel", "k", 450, 100),  # overlaps the copy: 50 more in enqueue
        x("kernel", "k", 2500, 100),
    ]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    rows = tprof.span_rows(str(tmp_path), per=2)
    step, up, enq = rows["pipeline.step"], rows["pipeline.upload"], rows["pipeline.enqueue"]
    assert (step.n, up.n, enq.n) == (2, 1, 1)
    assert step.ms == pytest.approx(1.0) and step.self_ms == pytest.approx(0.55)
    assert step.idle_ms == pytest.approx((2000 - 250 - 100) / 2e3)
    assert up.ms == pytest.approx(0.2) and up.idle_ms == pytest.approx(0.15)
    assert enq.ms == pytest.approx(0.25) and enq.idle_ms == pytest.approx((500 - 150) / 2e3)
