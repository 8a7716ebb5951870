"""Session parity: the port's GameSession vs the JAX GameSession.

Both sessions see the same rendered 1280x720 frames of one scripted move
and must commit the same move on the same frame and reach the same FEN.
Unpatched, both sessions pick the Hough backend with ``auto``: exact on the
CPU in both packages. The conv cases force the JAX session's pipeline to
conv by patching the name its module builds pipelines from, in this test
only, and name conv on the port's session. Both sessions take the host
HWC camera frames planar (the matmul resample), as the JAX ``step`` takes
a host frame. The enhanced sessions (``"use_enhancer": true``) run the JAX
package's XLA forms of the bilateral and CLAHE, which its ``auto`` backend
picks on a CPU: 26 frames with the TPU kernels in interpret mode would take
minutes. tests/test_torch_pipeline.py holds the enhanced step against the
TPU kernels themselves.
"""

import functools
import types

import numpy as np
import pytest
import torch

from chessboard_vision_tpu.models.pipeline import VisionPipeline as JaxPipeline
from chessboard_vision_tpu.rules import chess
from chessboard_vision_tpu.session import game_session as jax_session_mod
from chessboard_vision_tpu_torch.session.game_session import GameSession as TorchSession
from chessboard_vision_tpu_torch.tools.demo_pipeline import occupancy_of

from fixtures import DEFAULT_CORNERS, make_board_frame

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

CONFIG = {
    "corners": DEFAULT_CORNERS.tolist(),
    "player_color": "white",
    "orientation_flipped": False,
    "grid_lines_x": None,
    "grid_lines_y": None,
}


def _drive(session, frames):
    """Feed frames until a move commits; (move uci, frame index) or None."""
    for i, fr in enumerate(frames):
        move = session.on_frame(fr)
        if move:
            return move.uci(), i
    return None


def _parity(monkeypatch, config, uci, backend="conv"):
    if backend == "conv":
        monkeypatch.setattr(
            jax_session_mod, "VisionPipeline",
            functools.partial(JaxPipeline, hough_backend="conv"),
        )
    rng = np.random.default_rng(11)
    script = chess.Board()
    frame0 = make_board_frame(occupancy_of(script), rng)
    script.push_uci(uci)
    frames = [make_board_frame(occupancy_of(script), rng) for _ in range(26)]

    jsess = jax_session_mod.GameSession(headless=True)
    tsess = TorchSession(device="cpu", hough_backend=backend)
    assert jsess.on_calibration_requested(None, config=dict(config))
    assert tsess.on_calibration_requested(config=dict(config))
    for s in (jsess, tsess):
        s.MOVE_COOLDOWN = 0.0
        s.capture_reference_frame(frame0)
    want = "conv" if backend == "conv" else "exact"
    assert jsess.pipeline.hough_backend == tsess.pipeline.hough_backend == want
    assert tsess.pipeline.with_enhancer == jsess.pipeline.with_enhancer == bool(
        config.get("use_enhancer"))

    got_j, got_t = _drive(jsess, frames), _drive(tsess, frames)
    assert got_t is not None and got_t == got_j
    assert got_t[0] == uci
    assert tsess.game.get_fen() == jsess.game.get_fen() == script.fen()
    assert tsess.to_pgn() == jsess.to_pgn()


def test_port_session_commits_same_move_and_fen_as_jax(monkeypatch):
    _parity(monkeypatch, CONFIG, "e2e4")


def test_auto_backend_session_commits_same_move_and_fen_as_unpatched_jax(monkeypatch):
    """``auto`` on both sides, the JAX session unpatched: exact Hough in
    both packages on the CPU, the same move on the same frame."""
    _parity(monkeypatch, CONFIG, "e2e4", backend="auto")


def test_enhanced_session_commits_same_move_and_fen_as_jax(monkeypatch):
    """"use_enhancer": true with a color profile in the config: the same
    move on the same frame and the same FEN as the JAX session."""
    profile = {"contrast": 1.1, "brightness": 4, "sat_scale": 1.2}
    _parity(monkeypatch, {**CONFIG, "use_enhancer": True, "enhancer_profile": profile}, "e2e4")


def test_session_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchSession()


def test_headless_false_and_auto_recalibrate_are_not_ported(monkeypatch, tmp_path):
    """The UI and the interactive calibration tool are ported:
    ``headless=False`` keeps the flag (the session draws its overlay each
    frame, tests/test_torch_renderer.py), and with a camera and no saved
    calibration ``on_calibration_requested`` opens the calibration tool on
    the given gui; cancelled there ('q'), it returns False without a
    config. Drift re-calibration: ``"auto_recalibrate"`` (here through
    default_config_overrides, as play_lichess --auto-recalibrate sets it)
    gives the session a drift monitor on its device with the config's
    gates, and the calibration sets orientation_flipped as in the JAX
    package."""
    from chessboard_vision_tpu_torch.tools.process_video import FrameReader

    shown = TorchSession(device="cpu", headless=False)
    assert not shown.headless and TorchSession(device="cpu").headless
    monkeypatch.chdir(tmp_path)  # no calibration.json here
    windows = []
    gui = types.SimpleNamespace(
        namedWindow=windows.append, setMouseCallback=lambda window, callback: None,
        imshow=lambda window, img: None, waitKey=lambda ms: ord("q"),
        destroyAllWindows=lambda: windows.append("destroyed"))
    frame = make_board_frame(occupancy_of(chess.Board()), np.random.default_rng(3))
    cancelled = TorchSession(device="cpu")
    assert not cancelled.on_calibration_requested(cap=FrameReader([frame]), gui=gui)
    assert windows == ["Calibration", "destroyed"] and cancelled.config is None
    assert not TorchSession(device="cpu").on_calibration_requested()
    sess = TorchSession(device="cpu")
    sess.default_config_overrides = {"auto_recalibrate": True}
    assert sess.on_calibration_requested(config={**CONFIG, "orientation_flipped": True,
                                                 "drift_check_interval": 7,
                                                 "drift_threshold_px": 3.0})
    assert sess.config["auto_recalibrate"] and sess.orientation_flipped
    assert sess.drift_check_interval == 7 and sess.drift.threshold_px == 3.0
    np.testing.assert_array_equal(sess.drift.corners, DEFAULT_CORNERS)
    assert torch.device(sess.drift.device).type == "cpu"
    assert sess.clock_hud() == "" and sess.on_exit() is None


def test_capture_reference_reads_the_camera_after_its_warmup():
    """on_calibration_requested(cap, config) configures, then takes the
    reference from the frame the reader gives after ``warmup`` frames, as
    the JAX session does: both sessions then hold the same references."""
    from chessboard_vision_tpu_torch.tools.process_video import FrameReader

    rng = np.random.default_rng(21)
    frames = [make_board_frame(occupancy_of(chess.Board()), rng) for _ in range(12)]
    jsess = jax_session_mod.GameSession(headless=True)
    tsess = TorchSession(device="cpu")
    jcap, tcap = FrameReader(frames), FrameReader(frames)
    assert jsess.on_calibration_requested(jcap, config=dict(CONFIG))
    assert tsess.on_calibration_requested(tcap, config=dict(CONFIG))
    assert jcap.read()[1] is frames[11] and tcap.read()[1] is frames[11]
    np.testing.assert_array_equal(tsess.pipe_state.piece.ref_gray.cpu().numpy(),
                                  np.asarray(jsess.pipe_state.piece.ref_gray))
    assert tsess.pipe_state.piece.has_ref.all()


def test_demo_pipeline_plays_a_scripted_move(capsys):
    """The port's headless demo (numpy-rendered frames, CPU device)
    commits the scripted move and ends with the script's FEN."""
    from chessboard_vision_tpu_torch.tools import demo_pipeline

    assert demo_pipeline.main(["--moves", "d2d4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "detected + committed: d2d4" in out and out.rstrip().endswith("OK")


def test_frame_counted_cooldown_commits_on_the_same_frames_as_jax(monkeypatch):
    """cooldown_frames (the recorded-footage cooldown, in processed frames)
    on both sessions: e2e4, then e7e5 inside the cooldown. Both sessions
    hold e7e5 back until the cooldown has passed and commit each move on
    the same frame."""
    monkeypatch.setattr(jax_session_mod, "VisionPipeline",
                        functools.partial(JaxPipeline, hough_backend="conv"))
    rng = np.random.default_rng(12)
    script = chess.Board()
    frame0 = make_board_frame(occupancy_of(script), rng)
    frames = []
    for uci, n in (("e2e4", 22), ("e7e5", 30)):
        script.push_uci(uci)
        frames += [make_board_frame(occupancy_of(script), rng) for _ in range(n)]
    cooldown = 28
    jsess = jax_session_mod.GameSession(headless=True)
    tsess = TorchSession(device="cpu", hough_backend="conv")
    assert jsess.on_calibration_requested(None, config=dict(CONFIG))
    assert tsess.on_calibration_requested(config=dict(CONFIG))
    commits = []
    for s in (jsess, tsess):
        s.cooldown_frames = cooldown
        s.capture_reference_frame(frame0)
        commits.append([(m.uci(), s.frame_count) for m in map(s.on_frame, frames) if m])
    assert commits[1] == commits[0]
    (m1, f1), (m2, f2) = commits[1]
    assert (m1, m2) == ("e2e4", "e7e5")
    # e7e5 is stable 20 frames after it shows (frame 23): inside the
    # cooldown, so it commits on the first frame past it.
    assert f2 == f1 + cooldown + 1 and f2 > 23 + 20
    assert tsess.last_move_frame == jsess.last_move_frame == f2
    assert tsess.game.get_fen() == jsess.game.get_fen() == script.fen()
