"""The trace arithmetic on a synthetic trace: the window, the device's busy
time and idle share, launches against records, stages by launching frame,
the score matmul's time and each kernel call site's, and the idle gaps by
what the host was doing."""

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
    assert s.site_s == {tr.B1_SITE: s.b1_s}
    assert dict(s.idle_gaps) == pytest.approx({
        "idle": 2100e-6, "chessboard_vision_tpu_torch/ops/canny.py: canny": 150e-6})
    assert 100 * (1 - s.busy_s / s.window_s) == pytest.approx(75.0)


def test_stretch_without_stacks(tmp_path):
    s = tr.read(write(tmp_path, events(with_stack=False)))
    assert s.busy_s == pytest.approx(750e-6) and s.launches == 5
    assert s.stage_s == {} and s.b1_s == 0.0 and s.idle_gaps == [] and s.site_s == {}


def enhancer_events():
    """The synthetic trace with the enhancer's kernels launched in the second
    call: the bilateral (80 us) and the two CLAHE kernels (30 + 20 us), each
    under its kernels/ file, and a launch under a file of kernels/_build/
    that is no call site."""
    return events() + [
        x("cuda_runtime", "cudaLaunchKernel", 3400, 5, correlation=11),
        x("cuda_runtime", "cudaLaunchKernel", 3450, 5, correlation=12),
        x("cuda_runtime", "cudaLaunchKernel", 3460, 5, correlation=13),
        x("cuda_runtime", "cudaLaunchKernel", 3500, 5, correlation=14),
        x("kernel", "bilateral_planar_kernel", 3810, 80, correlation=11),
        x("kernel", "clahe_hist_tile_kernel", 3900, 30, correlation=12),
        x("kernel", "clahe_apply_kernel", 3930, 20, correlation=13),
        x("kernel", "stray", 3950, 10, correlation=14),
        py("models/enhancer.py(60): enhance", 3380, 100),
        py("kernels/bilateral.py(150): bilateral_planar", 3390, 20),
        py("ops/enhance.py(90): clahe", 3440, 30),
        py("kernels/clahe.py(200): clahe_hist_luts", 3445, 10),
        py("kernels/clahe.py(260): clahe_apply", 3458, 10),
        py("kernels/_build/gen.py(1): stray", 3495, 10),
    ]


def test_device_time_by_kernel_call_site(tmp_path):
    """Each record goes to every kernels/<file>.py around its launch, as the
    score matmul's always went to its file; b1_s is that file's share."""
    s = tr.read(write(tmp_path, enhancer_events()))
    assert s.site_s == pytest.approx({"kernels/score_matmul.py": 200e-6,
                                      "kernels/bilateral.py": 80e-6,
                                      "kernels/clahe.py": 50e-6})
    assert s.b1_s == s.site_s[tr.B1_SITE]
    assert s.stage_s["enhance"] == pytest.approx(130e-6)


def test_a_lost_record_shows(tmp_path):
    ev = [e for e in events() if not (e["cat"] == "kernel" and e["name"] == "graph")]
    s = tr.read(write(tmp_path, ev))
    assert (s.launches, s.records) == (5, 4)


def test_no_call_range_raises(tmp_path):
    with pytest.raises(ValueError):
        tr.read(write(tmp_path, [e for e in events() if e["cat"] != "user_annotation"]))
