"""The enhanced N-board tick against the benchmark's plain reference, and the
enhancer's span and counter, on the CPU.

``MultiStreamPipeline(with_enhancer=True)`` with one geometry a rig warps each
board in color with its own tile plan and enhances all boards in one batch
(models/enhancer.enhance_planar); benchmark/reference/enhanced_pipeline.py
does the same in plain torch, with plain copies of the kernels' plain
versions in place of the kernels. On rendered frames of two seeds every step output
and the noise FSM's flags are equal, bit for bit, through the capture, the
initial position, a hand, a refresh and a new position.

An enhanced call records one span ``pipeline.enhance`` inside
``pipeline.enqueue``, and B2-B4's launches in it in the counter
``pipeline.enhance_launches``: 0 on the CPU, where the plain versions run,
and 3 where the kernels run (stood in for here), one each for all boards. A
call without the enhancer records neither.

The resample kernel's launches in a call count in
``pipeline.resample_launches``: with the kernel stood in for, 1 a tick for
the per-rig hall, plain or enhanced (every board in one launch), and for a
single board's planar frame; 0 where HWC frames take the gather warp. On
the CPU, where the plain ops run, no call records it, and the outputs are
those of the stood-in kernel and of one resample a board.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import run, schedule
from benchmark.reference.enhanced_pipeline import EnhancedReferencePipeline
from benchmark.reference.fsm import init_state as fsm_state
from benchmark.reference.fsm import noise_step
from benchmark.reference.geometry import BoardGeometry as RefGeometry
from chessboard_vision_tpu_torch.geometry import BoardGeometry
from chessboard_vision_tpu_torch.kernels import bilateral as kb
from chessboard_vision_tpu_torch.kernels import clahe as kc
from chessboard_vision_tpu_torch.kernels import resample as kr
from chessboard_vision_tpu_torch.models.pipeline import VisionPipeline
from chessboard_vision_tpu_torch.ops import enhance as enh_ops
from chessboard_vision_tpu_torch.ops import matmul_resample as mr
from chessboard_vision_tpu_torch.ops.color import planar_bgr2gray
from chessboard_vision_tpu_torch.parallel.multistream import MultiStreamPipeline, outputs_to_numpy
from chessboard_vision_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOARDS = 3
SEED = 2**31 + 4321  # past 32 signed bits, as the benchmark's seeds are


def hall_config() -> dict:
    """The enhanced hall's configuration at 240x320 and 3 boards."""
    with open(os.path.join(ROOT, "benchmark", "configs", "hall_1080p_enhanced.json")) as fh:
        return dict(json.load(fh), frame_size=[240, 320], board_jitter_px=8, boards=BOARDS)


def rigs_and_frames(seed: int):
    """The rigs' corners and the frames of each call, rendered from the seed
    under the capacity mix with a move every 40 calls."""
    config = hall_config()
    with open(os.path.join(ROOT, "benchmark", "traffic", "capacity.json")) as fh:
        mix = dict(json.load(fh), warmup_calls=5, first_move_after=5, move_every=40,
                   hand_calls=6, stagger=10, max_moves=2)
    t = schedule.Traffic.from_json(mix, 4.0)
    corners = run.rig_corners(config, seed)
    scripts = [schedule.BoardScript(t, seed, b) for b in range(BOARDS)]
    bank = run.render_bank(config, scripts, corners, t.renders, seed, "cpu")
    return corners, run.Frames(bank, scripts, t.renders)


def geometries(corners, cls=BoardGeometry):
    return [cls.from_calibration(c, display_size=(320, 240)) for c in corners]


@pytest.mark.parametrize("seed", [SEED, 11])
def test_the_enhanced_hall_matches_the_plain_reference(seed):
    corners, frames = rigs_and_frames(seed)
    port = MultiStreamPipeline(geometries(corners), n_streams=BOARDS, with_enhancer=True,
                               hough_backend="conv", device="cpu")
    ref = EnhancedReferencePipeline(geometries(corners, RefGeometry), "cpu")
    ps = port.capture_reference(port.init_state(), frames(0))
    rs = ref.capture(ref.init_state(), torch.from_numpy(frames(0).copy()))
    fsm = fsm_state(BOARDS, device="cpu")
    # the initial position, a hand over the first board, a refresh, its new position
    for call in (1, 2, 12, 13, 14, 30):
        m = np.random.default_rng(call).random((BOARDS, 64)) < 0.5
        refresh = np.array([call == 13, False, call == 14])
        ps, po = port.step(ps, frames(call), s2c_masks=m, refresh=refresh)
        rs, ro = ref.step(rs, torch.from_numpy(frames(call).copy()), m, [True] * BOARDS, refresh)
        fsm, fo = noise_step(fsm, ro.visual_changes.reshape(BOARDS, 64))
        po = outputs_to_numpy(po)
        for name, a, b in zip(ro._fields, po.step, ro):
            np.testing.assert_array_equal(np.asarray(a).reshape(-1), b.numpy(), err_msg=name)
        np.testing.assert_array_equal(po.noise.blocked, fo.blocked.numpy())
    assert [s for s, _ in frames.index(30)] != [s for s, _ in frames.index(1)]  # a move made


def one_call(which: str, enhanced: bool):
    """One step of a pipeline on the CPU, its reference captured first, on a
    cleared table: the hall with a geometry a rig (its own color warps), the
    hall with one shared geometry (host HWC frames take the gather warp), or
    the single board (a host frame taken planar: the tile plan's warp)."""
    corners, frames = rigs_and_frames(SEED)
    kw = dict(with_enhancer=enhanced, hough_backend="conv", device="cpu")
    if which == "player":
        pipe = VisionPipeline(geometries(corners)[0], **kw)
        frame = frames(1)[0]
    else:
        g = geometries(corners)
        pipe = MultiStreamPipeline(g if which == "hall_rigs" else g[0], n_streams=BOARDS, **kw)
        frame = frames(1)
    state = pipe.capture_reference(pipe.init_state(), frame)
    tprof.clear()
    pipe.step(state, frame)
    (call,) = tprof.recorded_calls()
    return call


@pytest.fixture
def empty_table():
    tprof.clear()
    yield
    tprof.clear()


def assert_enhance_nested(call):
    """``pipeline.enhance`` once, the one child of ``pipeline.enqueue``."""
    s = call.spans
    assert call.root == "pipeline.step" and s["pipeline.enhance"].n == 1
    step, enq, enh = s["pipeline.step"], s["pipeline.enqueue"], s["pipeline.enhance"]
    assert step.self_ns + s["pipeline.upload"].total_ns + enq.total_ns == step.total_ns
    assert enq.self_ns + enh.total_ns == enq.total_ns and enh.total_ns > 0


@pytest.mark.parametrize("which", ["hall_rigs", "hall_shared", "player"])
def test_an_enhanced_call_records_the_enhance_span(empty_table, which):
    call = one_call(which, enhanced=True)
    assert_enhance_nested(call)
    assert dict(call.counts) == {"pipeline.enhance_launches": 0}  # plain versions on the CPU


@pytest.mark.parametrize("which", ["hall_rigs", "player"])
def test_the_enhance_counter_reads_the_kernels_launches(monkeypatch, empty_table, which):
    """With B2-B4 stood in for by their plain versions behind counting
    wrappers (the kernel wrappers' own counters), a call counts one launch
    of each, whatever its number of boards."""
    monkeypatch.setattr(enh_ops, "use_kernel", lambda t, backend, what: True)
    for name, plain, wrapper in (
        ("bilateral_planar", kb.bilateral_reference, kb.bilateral_planar),
        ("clahe_hist_luts", kc.clahe_hist_luts_reference, kc.clahe_hist_luts),
        ("clahe_apply", kc.clahe_apply_reference, kc.clahe_apply),
    ):
        monkeypatch.setattr(wrapper, "launches", wrapper.launches)  # restored after the test

        def launch(*a, plain=plain, wrapper=wrapper):
            wrapper.launches += 1
            return plain(*a)

        monkeypatch.setattr(enh_ops, name, launch)
    call = one_call(which, enhanced=True)
    assert_enhance_nested(call)
    assert dict(call.counts) == {"pipeline.enhance_launches": 3}


@pytest.mark.parametrize("which", ["hall_rigs", "player"])
def test_a_plain_call_records_neither(empty_table, which):
    call = one_call(which, enhanced=False)
    assert "pipeline.enhance" not in call.spans and dict(call.counts) == {}


def resample_call(which: str, enhanced: bool):
    """``one_call``, and the single board on an HWC tensor, which keeps its
    layout and takes the gather warp."""
    if which != "player_hwc":
        return one_call(which, enhanced)
    corners, frames = rigs_and_frames(SEED)
    pipe = VisionPipeline(geometries(corners)[0], with_enhancer=enhanced, hough_backend="conv",
                          device="cpu")
    frame = torch.from_numpy(frames(1)[0].copy())
    state = pipe.capture_reference(pipe.init_state(), frame)
    tprof.clear()
    pipe.step(state, frame)
    (call,) = tprof.recorded_calls()
    return call


@pytest.fixture
def resample_stood_in(monkeypatch):
    """The resample kernel stood in for by its plain version behind a
    counting wrapper (the kernel wrapper's own counter)."""
    monkeypatch.setattr(mr, "use_kernel", lambda frames: True)
    monkeypatch.setattr(kr.resample_u8, "launches", kr.resample_u8.launches)

    def launch(frames, plan, dims):
        kr.resample_u8.launches += 1
        return mr.resample_boards_plain(frames, plan, dims)

    monkeypatch.setattr(mr, "resample_u8", launch)


@pytest.mark.parametrize("which,enhanced,launches", [
    ("hall_rigs", False, 1), ("hall_rigs", True, 1), ("player", False, 1), ("player", True, 1),
    ("hall_shared", False, 0), ("player_hwc", False, 0), ("player_hwc", True, 0)])
def test_the_resample_counter_reads_the_kernels_launches(resample_stood_in, empty_table, which,
                                                         enhanced, launches):
    call = resample_call(which, enhanced)
    assert call.counts.get("pipeline.resample_launches", 0) == launches
    assert call.counts.get("pipeline.enhance_launches", 0) == 0  # B2-B4 run their plain versions


@pytest.mark.parametrize("enhanced", [False, True])
def test_on_the_cpu_no_call_counts_a_resample_and_the_outputs_stay(monkeypatch, empty_table,
                                                                   enhanced):
    """The per-rig hall on the CPU: no ``pipeline.resample_launches``, and
    the tick's outputs equal those with the kernel stood in for."""
    corners, frames = rigs_and_frames(SEED)
    pipe = MultiStreamPipeline(geometries(corners), n_streams=BOARDS, with_enhancer=enhanced,
                               hough_backend="conv", device="cpu")
    state = pipe.capture_reference(pipe.init_state(), frames(0))
    tprof.clear()
    _, plain = pipe.step(state, frames(1))
    (call,) = tprof.recorded_calls()
    assert "pipeline.resample_launches" not in call.counts
    with monkeypatch.context() as m:
        m.setattr(mr, "use_kernel", lambda frames: True)
        m.setattr(mr, "resample_u8", mr.resample_boards_plain)
        _, stood_in = pipe.step(state, frames(1))
    for a, b in zip(outputs_to_numpy(plain).step, outputs_to_numpy(stood_in).step):
        np.testing.assert_array_equal(a, b)


def test_the_hall_squares_are_one_resample_a_board(empty_table):
    """The per-rig hall's squares, every board in one resample, equal each
    board's own ``resample_gray_u8`` with its plan, bit for bit."""
    corners, frames = rigs_and_frames(SEED)
    pipe = MultiStreamPipeline(geometries(corners), n_streams=BOARDS, hough_backend="conv",
                               device="cpu")
    planar = torch.from_numpy(frames(1).copy()).movedim(-1, -3)
    got, _ = pipe._squares(planar)
    gray = planar_bgr2gray(planar)
    padded = torch.cat([mr.resample_gray_u8(gray[i], *mr.build_plan(
        *g.square_query_coords(), g.src_h, g.src_w, device="cpu"))
        for i, g in enumerate(geometries(corners))])
    want, _ = pipe.pipe.blur(padded)
    assert torch.equal(got, want)
