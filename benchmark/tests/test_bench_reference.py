"""The plain reference against the port's CPU path (the conv Hough with its
plain score matmul) on rendered frames of each configuration at a reduced
size: every step output equal, bit for bit, and the N-board FSM's flags."""

import numpy as np
import pytest
import torch

from benchmark import run, schedule
from benchmark.reference import sessions
from benchmark.reference.geometry import BoardGeometry as RefGeometry
from benchmark.reference.fsm import init_state as fsm_state
from benchmark.reference.fsm import noise_step
from benchmark.reference.pipeline import ReferencePipeline
from benchmark.tests import tiny


def bank_and_frames(cell, seed):
    t = schedule.Traffic.from_json(cell.traffic, 4.0)
    corners = run.rig_corners(cell.config, seed)
    scripts = [schedule.BoardScript(t, seed, b) for b in range(cell.config["boards"])]
    bank = run.render_bank(cell.config, scripts, corners, t.renders, seed, "cpu")
    return corners, run.Frames(bank, scripts, t.renders)


def masks_for(call, boards):
    rng = np.random.default_rng(call)
    return rng.random((boards, 64)) < 0.5


@pytest.mark.parametrize("seed", [tiny.SEED, 11])
def test_player_pipeline(seed):
    from chessboard_vision_tpu_torch.geometry import BoardGeometry
    from chessboard_vision_tpu_torch.models.pipeline import VisionPipeline, outputs_to_numpy

    cell = tiny.player()
    corners, frames = bank_and_frames(cell, seed)
    h, w = cell.config["frame_size"]
    port = VisionPipeline(BoardGeometry.from_calibration(corners[0], display_size=(w, h)),
                          hough_backend="conv", device="cpu")
    ref = ReferencePipeline([RefGeometry.from_calibration(corners[0], display_size=(w, h))], "cpu")
    ps = port.capture_reference(port.init_state(), frames(0)[0])
    rs = ref.capture(ref.init_state(), torch.from_numpy(frames(0)))
    for call in (1, 2, 3, 12, 13, 40):  # the initial position, a hand, a new position
        m = masks_for(call, 1)
        given, refresh = call % 3 != 0, call == 13
        ps, po = port.step(ps, frames(call)[0], squares_to_check=(
            {(q % 8, q // 8) for q in np.flatnonzero(m[0])} if given else None), refresh_refs=refresh)
        rs, ro = ref.step(rs, torch.from_numpy(frames(call)), m if given else np.zeros_like(m),
                          [given], [refresh])
        for name, a, b in zip(ro._fields, outputs_to_numpy(po), ro):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


@pytest.mark.parametrize("seed", [tiny.SEED, 11])
def test_hall_pipeline(seed):
    from chessboard_vision_tpu_torch.geometry import BoardGeometry
    from chessboard_vision_tpu_torch.parallel.multistream import (MultiStreamPipeline,
                                                                  outputs_to_numpy)

    cell = tiny.hall(boards=3)
    corners, frames = bank_and_frames(cell, seed)
    h, w = cell.config["frame_size"]
    port = MultiStreamPipeline([BoardGeometry.from_calibration(c, display_size=(w, h))
                                for c in corners], n_streams=3, hough_backend="conv",
                               device="cpu")
    ref = ReferencePipeline([RefGeometry.from_calibration(c, display_size=(w, h))
                             for c in corners], "cpu")
    ps = port.capture_reference(port.init_state(), frames(0))
    rs = ref.capture(ref.init_state(), torch.from_numpy(frames(0).copy()))
    fsm = fsm_state(3, device="cpu")
    for call in (1, 2, 3, 10, 11, 12, 13, 40):
        m = masks_for(call, 3)
        refresh = np.array([call == 11, False, call == 13])
        ps, po = port.step(ps, frames(call), s2c_masks=m, refresh=refresh)
        rs, ro = ref.step(rs, torch.from_numpy(frames(call).copy()), m, [True] * 3, refresh)
        fsm, fo = noise_step(fsm, ro.visual_changes.reshape(3, 64))
        po = outputs_to_numpy(po)
        for name, a, b in zip(ro._fields, po.step, ro):
            np.testing.assert_array_equal(np.asarray(a).reshape(-1), b.numpy(), err_msg=name)
        np.testing.assert_array_equal(po.noise.blocked, fo.blocked.numpy())


def test_session_rules_follow_the_port():
    """The reference sessions commit what the port's sessions commit, on the
    same calls (the whole comparison of a run, at a reduced size)."""
    for cell in (tiny.player(), tiny.hall(boards=2)):
        r = tiny.run_cpu(cell, seconds=4.0)
        assert r["correct"] and r["checks"]["commit_mismatches"]["value"] == 0


def test_reference_sessions_commit_the_script():
    """Sanity of the yardstick: on the tiny player cell, the reference's own
    session commits the scripted moves in order."""
    cell = tiny.player()
    t = schedule.Traffic.from_json(cell.traffic, 4.0)
    corners, frames = bank_and_frames(cell, tiny.SEED)
    script = frames.scripts[0]
    h, w = cell.config["frame_size"]
    s = sessions.ReferencePlayer(ReferencePipeline(
        [RefGeometry.from_calibration(corners[0], display_size=(w, h))], "cpu"))
    s.capture(torch.from_numpy(frames(0)))
    end = t.warmup_calls + t.first_move_after + 3 * t.move_every
    for c in range(end):
        s.call(torch.from_numpy(frames(c)), now=c / t.rate_hz)
    assert [u for _, u in s.board.commits] == [m.uci() for m in script.moves[:len(s.board.commits)]]
    assert len(s.board.commits) >= 2
