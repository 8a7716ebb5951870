"""Drift re-calibration through the port vs the JAX package (session/drift.py).

Every test of tests/test_drift_recalibration.py, each run through both
packages on the same rendered 1280x720 frames (a camera bumped by (12, 7)
px mid-game): the DriftMonitors report the same corners on the same
checks; the sessions recalibrate on the same frame to the same corners and
commit the same moves on the same frames with the same FEN. The JAX
detector is cv2, the port's is cv2-free (its image stages in torch on the
CPU here). Both packages' ``auto`` Hough backend is exact on the CPU; the
enhanced multi-stream sessions run the JAX package's XLA forms of the
bilateral and CLAHE, which its ``auto`` backend picks on a CPU.
"""

import numpy as np
import torch

from chessboard_vision_tpu import geometry as jgeo
from chessboard_vision_tpu.parallel.session import MultiStreamSession as JaxMultiSession
from chessboard_vision_tpu.session.drift import DriftMonitor as JaxMonitor
from chessboard_vision_tpu.session.game_session import GameSession as JaxSession
from chessboard_vision_tpu_torch import geometry as tgeo
from chessboard_vision_tpu_torch.parallel.session import MultiStreamSession as TorchMultiSession
from chessboard_vision_tpu_torch.session.drift import DriftMonitor as TorchMonitor
from chessboard_vision_tpu_torch.session.game_session import GameSession as TorchSession

from fixtures import DEFAULT_CORNERS, initial_occupancy, make_board_frame

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

BUMP = np.array([[12, 7]] * 4, np.float64)  # a rigid camera nudge
BUMPED = np.asarray(DEFAULT_CORNERS, np.float64) + BUMP


def _config(**extra):
    cfg = {
        "corners": np.asarray(DEFAULT_CORNERS).tolist(),
        "player_color": "white",
        "orientation_flipped": False,
    }
    cfg.update(extra)
    return cfg


def _after_e2e4():
    occ = initial_occupancy()
    occ[4, 1] = False
    occ[4, 3] = True
    return occ


def _monitor_checks(frames, **kw):
    """Both packages' monitors over the same frames: the port's results,
    each equal to the JAX monitor's on the same check."""
    jmon = JaxMonitor(np.asarray(DEFAULT_CORNERS, np.float64), **kw)
    tmon = TorchMonitor(np.asarray(DEFAULT_CORNERS, np.float64), device="cpu", **kw)
    got = []
    for i, frame in enumerate(frames):
        want, res = jmon.check(frame), tmon.check(frame)
        assert (res is None) == (want is None), f"check {i}: {res} vs {want}"
        if res is not None:
            np.testing.assert_array_equal(res, want)
        got.append(res)
    return got


def test_monitor_bump_reported_once_with_bias_cancelled():
    rng = np.random.default_rng(3)
    occ = initial_occupancy()
    frames = [make_board_frame(occ, rng) for _ in range(3)]
    frames += [make_board_frame(occ, rng, corners=BUMPED) for _ in range(5)]
    got = _monitor_checks(frames, confirm=2)
    # the baseline and steady checks, then the first bumped check only arms
    assert got[:4] == [None] * 4
    assert got[4] is not None and np.abs(got[4] - BUMPED).max() <= 1.5, got[4] - BUMPED
    assert got[5:] == [None] * 3  # re-based: the same bumped scene reports nothing


def test_monitor_unstable_detections_never_confirm():
    rng = np.random.default_rng(4)
    occ = initial_occupancy()
    base = np.asarray(DEFAULT_CORNERS, np.float64)
    frames = [make_board_frame(occ, rng)]
    frames += [make_board_frame(occ, rng, corners=base + BUMP * (1 + 2 * (k % 2)))
               for k in range(6)]
    assert _monitor_checks(frames, confirm=2) == [None] * 7


def test_huge_shift_is_treated_as_misdetection():
    rng = np.random.default_rng(10)
    occ = initial_occupancy()
    far = np.asarray(DEFAULT_CORNERS, np.float64) + np.array([[120, 0]] * 4)
    frames = [make_board_frame(occ, rng)] + [make_board_frame(occ, rng, corners=far)
                                             for _ in range(4)]
    assert _monitor_checks(frames, confirm=2, max_px=80.0) == [None] * 5


def _session_log(session, frames):
    """(committed move or None, the config's corners) after each frame."""
    log = []
    for fr in frames:
        move = session.on_frame(fr)
        log.append((move and move.uci(), [list(map(int, c)) for c in session.config["corners"]]))
    return log


def _sessions(**cfg):
    out = []
    for s in (JaxSession(headless=True), TorchSession(device="cpu")):
        s.configure(_config(**cfg))
        s.STABILITY_REQUIRED = 4
        s.MOVE_COOLDOWN = 0.0
        out.append(s)
    return out


def test_session_move_commits_after_camera_bump():
    """Calibrate, bump the camera, the sessions detect the drift and rebuild
    the geometry mid-game; e2e4 played at the NEW corners commits. Both
    sessions recalibrate on the same frame to the same corners and commit
    on the same frame with the same FEN."""
    rng = np.random.default_rng(5)
    occ = initial_occupancy()
    ref = make_board_frame(occ, rng)
    frames = [make_board_frame(occ, rng) for _ in range(6)]
    frames += [make_board_frame(occ, rng, corners=BUMPED) for _ in range(12)]
    frames += [make_board_frame(_after_e2e4(), rng, corners=BUMPED) for _ in range(14)]
    jsess, tsess = _sessions(auto_recalibrate=True, drift_check_interval=5,
                             drift_confirm_checks=2)
    logs = []
    for s in (jsess, tsess):
        s.capture_reference_frame(ref)
        logs.append(_session_log(s, frames))
    assert logs[1] == logs[0]
    old = [list(map(int, c)) for c in DEFAULT_CORNERS]
    recal = next(i for i, (_, corners) in enumerate(logs[1]) if corners != old)
    assert 6 <= recal < 18, "no recalibration on the bumped frames"
    assert np.abs(np.asarray(logs[1][recal][1], np.float64) - BUMPED).max() <= 2.0
    moves = [(i, m) for i, (m, _) in enumerate(logs[1]) if m]
    assert [m for _, m in moves] == ["e2e4"] and moves[0][0] >= 18
    assert tsess.game.get_fen() == jsess.game.get_fen()
    assert tsess.pipeline.device.type == torch.device(tsess.drift.device).type == "cpu"


def test_checkpoint_after_recalibration_resumes_with_new_corners(tmp_path):
    """A session that recalibrated saves the UPDATED corners; a fresh
    session resuming the checkpoint builds the shifted geometry and commits
    e2e4 at the bumped corners, on the same frame in both packages."""
    rng = np.random.default_rng(9)
    occ = initial_occupancy()
    ref = make_board_frame(occ, rng)
    bumped = [make_board_frame(occ, rng, corners=BUMPED) for _ in range(12)]
    after = [make_board_frame(_after_e2e4(), rng, corners=BUMPED) for _ in range(14)]
    logs = []
    for pkg, s in zip(("jax", "port"), _sessions(auto_recalibrate=True, drift_check_interval=5,
                                                 drift_confirm_checks=2)):
        s.capture_reference_frame(ref)
        for fr in bumped:
            s.on_frame(fr)
        assert np.abs(np.asarray(s.config["corners"], np.float64) - BUMPED).max() <= 2.0
        ckpt = str(tmp_path / f"{pkg}.npz")
        s.save_checkpoint(ckpt)
        fresh = JaxSession(headless=True) if pkg == "jax" else TorchSession(device="cpu")
        fresh.STABILITY_REQUIRED = 4
        fresh.MOVE_COOLDOWN = 0.0
        fresh.resume_checkpoint(ckpt)
        assert fresh.config["corners"] == s.config["corners"]
        logs.append((_session_log(fresh, after), fresh.game.get_fen()))
    assert logs[1] == logs[0]
    assert [m for m, _ in logs[1][0] if m] == ["e2e4"]


def _multi_frames(rng, occ0, occ1, c0=DEFAULT_CORNERS, c1=DEFAULT_CORNERS):
    return np.stack([make_board_frame(occ0, rng, corners=c0),
                     make_board_frame(occ1, rng, corners=c1)])


def _multi_parity(seed, **kw):
    """Two rigs, rig 0 bumped: both packages' MultiStreamSessions rebuild in
    per-stream-geometry mode on the same tick with the same corners, and
    both rigs then commit e2e4 on the same ticks."""
    rng = np.random.default_rng(seed)
    occ, after = initial_occupancy(), _after_e2e4()
    ref = _multi_frames(rng, occ, occ)
    ticks = [_multi_frames(rng, occ, occ) for _ in range(5)]
    ticks += [_multi_frames(rng, occ, occ, c0=BUMPED) for _ in range(10)]
    ticks += [_multi_frames(rng, after, after, c0=BUMPED) for _ in range(14)]
    opts = dict(n_streams=2, auto_recalibrate=True, drift_check_interval=4, drift_confirm=2, **kw)
    jsess = JaxMultiSession(jgeo.BoardGeometry.from_calibration(np.asarray(DEFAULT_CORNERS)),
                            **opts)
    tsess = TorchMultiSession(tgeo.BoardGeometry.from_calibration(np.asarray(DEFAULT_CORNERS)),
                              device="cpu", **opts)
    logs = []
    for s in (jsess, tsess):
        s.STABILITY_REQUIRED = 4
        s.MOVE_COOLDOWN = 0.0
        s.capture_reference(ref)
        log = []
        for frames in ticks:
            moves = [m and m.uci() for m in s.on_frames(frames)]
            log.append((moves, s.ms._stream_plans is not None,
                        [np.asarray(g.src_corners).tolist() for g in s.geometries]))
        logs.append(log)
    assert logs[1] == logs[0]
    rebuilt = next(t for t, (_, per_stream, _) in enumerate(logs[1]) if per_stream)
    assert 5 <= rebuilt < 15, "no per-stream rebuild on the bumped ticks"
    assert logs[1][:5] == [([None, None], False, logs[1][0][2])] * 5
    assert np.abs(np.asarray(tsess.geometries[0].src_corners, np.float64) - BUMPED).max() <= 2.0
    np.testing.assert_array_equal(tsess.geometries[1].src_corners, DEFAULT_CORNERS)
    commits = [[m for moves, _, _ in logs[1] if (m := moves[s])] for s in range(2)]
    assert commits == [["e2e4"], ["e2e4"]]
    for s in range(2):
        assert tsess.streams[s].game.get_fen() == jsess.streams[s].game.get_fen()
    return tsess


def test_multistream_one_rig_bumped_other_keeps_playing():
    _multi_parity(6)


def test_enhanced_session_survives_per_stream_rebuild():
    """with_enhancer composes with the rebuild: the bumped rig forces
    per-stream tile plans, and both rigs keep committing moves with the
    enhancement still fused in."""
    tsess = _multi_parity(13, with_enhancer=True,
                          enhancer_profile={"contrast": 1.05, "brightness": 3})
    assert tsess.ms.pipe.with_enhancer, "enhancer lost across the rebuild"
