"""The trace arithmetic on a synthetic trace: the window, the device's busy
time and idle share, launches against records, stages by launching frame,
the score matmul's time, and the idle gaps by what the host was doing."""

import json

import pytest

from benchmark import trace as tr

P, T = 1, 2  # the host process and thread
PKG = "/ck/chessboard_vision_tpu_torch/"


def x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": P, "tid": T,
            "args": args}


def py(path, ts, dur):
    return x("python_function", PKG + path, ts, dur)


def events(with_stack=True):
    ev = [
        x("user_annotation", tr.CALL_RANGE, 1000, 1000),
        x("user_annotation", tr.CALL_RANGE, 3000, 1000),
        x("cuda_runtime", "cudaLaunchKernel", 500, 5, correlation=9),  # a pad
        x("cuda_runtime", "cudaLaunchKernel", 1100, 5, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 1200, 5, correlation=2),
        x("cuda_runtime", "cudaMemcpyAsync", 1300, 5, correlation=5),
        x("cuda_runtime", "cudaLaunchKernel", 3100, 5, correlation=3),
        x("cuda_runtime", "cudaGraphLaunch", 3200, 5, correlation=4),
        x("cuda_runtime", "cudaStreamSynchronize", 3900, 50, correlation=6),
        x("kernel", "pad", 600, 50, correlation=9),
        x("kernel", "k_a", 1150, 100, correlation=1),
        x("kernel", "score", 1300, 200, correlation=2),
        x("gpu_memcpy", "Memcpy HtoD", 1250, 100, correlation=5),
        x("kernel", "k_a", 3300, 300, correlation=3),
        x("kernel", "graph", 3700, 100, correlation=4),
    ]
    if with_stack:
        ev += [
            py("ops/canny.py(10): canny", 1050, 130),
            py("ops/hough_conv.py(300): find_circle", 1185, 215),
            py("kernels/score_matmul.py(90): score_matmul", 1190, 20),
            py("models/pipeline.py(400): upload", 1290, 20),
            py("ops/matmul_resample.py(5): resample", 3050, 100),
        ]
    return ev


def write(tmp_path, ev):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_stretch_with_stacks(tmp_path):
    s = tr.read(write(tmp_path, events()))
    assert s.calls == 2
    assert s.window_s == pytest.approx(3000e-6)
    assert s.busy_s == pytest.approx(750e-6)  # 1150-1500, 3300-3600, 3700-3800
    assert (s.launches, s.records) == (5, 5)  # the pad's launch is outside the calls
    assert dict(s.device_ops) == pytest.approx({"k_a": 400e-6, "score": 200e-6,
                                                "Memcpy HtoD": 100e-6, "graph": 100e-6})
    assert s.stage_s == pytest.approx({"hough": 300e-6, "warp_extract": 300e-6,
                                       "upload": 100e-6, "other": 100e-6})
    assert s.b1_s == pytest.approx(200e-6)
    assert dict(s.idle_gaps) == pytest.approx({
        "idle": 2100e-6, "chessboard_vision_tpu_torch/ops/canny.py: canny": 150e-6})
    assert 100 * (1 - s.busy_s / s.window_s) == pytest.approx(75.0)


def test_stretch_without_stacks(tmp_path):
    s = tr.read(write(tmp_path, events(with_stack=False)))
    assert s.busy_s == pytest.approx(750e-6) and s.launches == 5
    assert s.stage_s == {} and s.b1_s == 0.0 and s.idle_gaps == []


def test_a_lost_record_shows(tmp_path):
    ev = [e for e in events() if not (e["cat"] == "kernel" and e["name"] == "graph")]
    s = tr.read(write(tmp_path, ev))
    assert (s.launches, s.records) == (5, 4)


def test_no_call_range_raises(tmp_path):
    with pytest.raises(ValueError):
        tr.read(write(tmp_path, [e for e in events() if e["cat"] != "user_annotation"]))
