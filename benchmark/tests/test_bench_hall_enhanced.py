"""The enhanced hall: its cell and reference found by name, a whole run of a
small enhanced hall on the CPU held to the plain reference, a reference with
one stage altered and the lower-precision control both failing the limits,
and its six metric readers on synthetic records, the two roofline bounds at
the cell's own sizes among them."""

import json
import os
import time

import numpy as np
import pytest

from benchmark import compare, run
from benchmark.tests import tiny
from benchmark.tests.test_bench_manifest import add_cell, checkout, run_tiny  # noqa: F401
from benchmark.trace import Stretch
from chessboard_vision_tpu_torch.utils import profiling as tprof

CELL = "hall_1080p_enhanced.capacity"
CONFIG = {"frame_size": [1080, 1920], "boards": 8}  # the cell's sizes


def small(boards: int = 2) -> run.Cell:
    return tiny.cell("hall_1080p_enhanced", "capacity", boards=boards, stagger=10, max_moves=2)


def test_the_cell_and_its_reference_are_found_by_name():
    cell = run.find_cell(tiny.ROOT, CELL)
    assert cell.config["pipeline"] == {"hough_backend": "conv", "use_enhancer": True}
    assert cell.config["reference"] == "enhanced_pipeline"
    assert compare.unimplemented(cell.config, tiny.ROOT) == []
    assert [m["name"] for m in cell.end_to_end] == ["frame_p95_ms", "frames_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "enhance_host_ms.hall_enhanced", "enhance_launches.hall_enhanced",
        "device_ms.enhance.hall_enhanced", "device_ms.color.hall_enhanced",
        "b2_roofline_pct.hall_enhanced", "clahe_roofline_pct.hall_enhanced"]
    with open(os.path.join(tiny.ROOT, "benchmark", "configs", "hall_1080p.json")) as fh:
        plain = json.load(fh)
    for key in ("frame_size", "boards", "board_jitter_px", "session", "limits", "reduced"):
        assert cell.config[key] == plain[key], key


def test_a_small_enhanced_hall_is_correct():
    """Every check at 0; the enhancer's span read, and its launch counter 0
    on the CPU, where B2-B4's plain versions run."""
    r, record = run.run_cell(small(), tiny.SEED, 4.0, False, device="cpu",
                             t_start=time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0
    assert all(v["value"] == 0 for v in r["checks"].values()), r["checks"]
    assert run.metric_reader("enhance_host_ms.hall_enhanced")(record) > 0
    assert run.metric_reader("enhance_launches.hall_enhanced")(record) == 0


def test_the_control_fails_the_limits():
    """The reference with its color warp in bfloat16, in the program's place,
    reads above a limit."""
    r = tiny.run_cpu(small(), seconds=3.0, control=True)
    assert r["correct"] is True
    assert any(v["value"] > v["limit"] for v in r["control"].values()), r["control"]


ALTERED = '''"""The enhanced reference with the stage {stage} left out."""

import torch

from . import enhance, enhanced_pipeline
from .color import planar_bgr2gray
from .filters import gaussian_blur_valid, normalize_minmax, sharpen

IMPLEMENTS = enhanced_pipeline.IMPLEMENTS


def altered(boards):
    x = boards if {stage!r} == "clahe" else enhance.correct_lighting(boards)
    x = x if {stage!r} == "bilateral" else enhance.reduce_noise(x)
    return normalize_minmax(sharpen(x))


class Altered(enhanced_pipeline.EnhancedReferencePipeline):
    def squares(self, frames):
        planar = frames.to(self.device).movedim(-1, -3)
        boards = torch.stack([self.board(planar[i], i) for i in range(self.n)])
        gray = planar_bgr2gray(altered(boards))
        padded = gray.reshape(self.n, -1)[:, self.ext_index]
        return gaussian_blur_valid(padded.reshape((-1,) + tuple(padded.shape[-2:])), 5,
                                   pad=self.pad)


def build(config, geometries, device, resample_dtype):
    return Altered(geometries, device, resample_dtype)
'''


@pytest.mark.parametrize("stage", ["clahe", "bilateral"])
def test_a_reference_with_a_stage_left_out_is_not_correct(checkout, stage):  # noqa: F811
    """A copy of the enhanced reference that skips CLAHE (or the bilateral
    filter), added as a file beside it and named by the configuration: the
    program, which runs every stage, is held not correct."""
    workload = add_cell(checkout, f"hall_no_{stage}", reference=f"no_{stage}",
                        pipeline={"hough_backend": "conv", "use_enhancer": True},
                        files={f"reference/no_{stage}.py": ALTERED.format(stage=stage)})
    r, record = run_tiny(checkout, workload)
    assert record.config["reference"] == f"no_{stage}"
    assert r["correct"] is False
    assert r["checks"]["vision_mismatch_pct"]["value"] > 0


def record(config=CONFIG, stretches=(), call_s=()) -> run.Record:
    return run.Record(window_s=1.0, setup_s=0.0, latency_s=np.zeros(0), frames_done=0,
                      wait_s=np.zeros(0), call_s=np.asarray(call_s, np.float64),
                      step_s=np.zeros(len(call_s)), stretches=list(stretches),
                      b1_shape=(1, 1, 1), config=config)


def stretch(calls=20, stage_s=None, site_s=None) -> Stretch:
    return Stretch(calls=calls, window_s=1.0, busy_s=0.5, launches=0, records=0, device_ops=[],
                   stage_s=stage_s or {}, b1_s=0.0, idle_gaps=[], site_s=site_s or {})


def test_the_bounds_at_the_cells_sizes():
    """B2 by operations, B3 and B4 by bytes, at 8 boards of 980^2 (the
    chip-smoke table's bounds at N = 8)."""
    b2 = run.load_file(tiny.ROOT, "metrics", "b2_roofline_pct.hall_enhanced").bound_s(CONFIG)
    hist, apply = run.load_file(tiny.ROOT, "metrics",
                                "clahe_roofline_pct.hall_enhanced").bounds_s(CONFIG)
    assert round(b2 * 1e6, 2) == 84.29
    assert b2 == pytest.approx(49 * 15 * 980 ** 2 * 8 / 67e12)
    assert (round(hist * 1e6, 2), round(apply * 1e6, 2)) == (2.61, 4.74)
    assert hist == pytest.approx((980 ** 2 + 8 * 64 * 256) * 8 / 3.35e12)
    assert apply == pytest.approx((2 * 980 ** 2 + 4 * 64 * 256) * 8 / 3.35e12)


def test_the_device_readers():
    """The stretch with stacks: ms a tick by stage, and each roofline share a
    tick at the kernels' times alone (224.72 us for B2, 11.42 + 20.30 us for
    B3 + B4 at N = 8) reading the shares found alone, 38% and 23%."""
    s = stretch(stage_s={"enhance": 20 * 1e-3, "color": 20 * 0.5e-3},
                site_s={"kernels/bilateral.py": 20 * 224.72e-6,
                        "kernels/clahe.py": 20 * (11.42 + 20.30) * 1e-6})
    r = record(stretches=[stretch(), s])
    read = {name: run.metric_reader(name)(r) for name in (
        "device_ms.enhance.hall_enhanced", "device_ms.color.hall_enhanced",
        "b2_roofline_pct.hall_enhanced", "clahe_roofline_pct.hall_enhanced")}
    assert read["device_ms.enhance.hall_enhanced"] == pytest.approx(1.0)
    assert read["device_ms.color.hall_enhanced"] == pytest.approx(0.5)
    assert round(read["b2_roofline_pct.hall_enhanced"]) == 38
    assert round(read["clahe_roofline_pct.hall_enhanced"]) == 23
    for missing in (record(), record(stretches=[s]), record(stretches=[stretch(), stretch()])):
        assert all(run.metric_reader(name)(missing) is None for name in read)


@pytest.fixture
def empty_table():
    tprof.clear()
    yield
    tprof.clear()


@pytest.mark.parametrize("enhanced", [True, False])
def test_the_span_readers(empty_table, enhanced):
    """Means over the window's ticks of ``pipeline.enhance`` and
    ``pipeline.enhance_launches``; None for a program that records neither
    (a plain tick, or a parent without the enhancer's span)."""
    for k in range(6):  # 1 before the window, 4 timed, 1 traced
        with tprof.span("session.on_frames"):
            with tprof.span("pipeline.step"):
                with tprof.span("pipeline.enqueue"):
                    if enhanced:
                        with tprof.span("pipeline.enhance"):
                            tprof.count("pipeline.enhance_launches", 3 + (k == 4))
    r = record(stretches=[stretch(calls=1)], call_s=[1.0] * 4)
    host = run.metric_reader("enhance_host_ms.hall_enhanced")(r)
    launches = run.metric_reader("enhance_launches.hall_enhanced")(r)
    if enhanced:
        calls = tprof.recorded_calls()[1:5]
        assert host == pytest.approx(np.mean([c.ms("pipeline.enhance") for c in calls]))
        assert launches == 3.25
    else:
        assert host is None and launches is None


def test_the_plain_stages_take_each_board_on_its_own():
    """The reference's enhancement of a batch of boards is each board's own,
    bit for bit: no stage mixes boards."""
    import torch

    from benchmark.reference.enhance import enhance

    gen = torch.Generator().manual_seed(tiny.SEED % 2**63)
    boards = torch.randint(0, 256, (3, 3, 44, 52), dtype=torch.uint8, generator=gen)
    boards[1] //= 4  # a dark board: its own min-max and CLAHE LUTs
    got = enhance(boards)
    for b in range(3):
        assert torch.equal(got[b], enhance(boards[b])), b
