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


def test_demo_pipeline_plays_a_scripted_move(capsys):
    """The port's headless demo (numpy-rendered frames, CPU device)
    commits the scripted move and ends with the script's FEN."""
    from chessboard_vision_tpu_torch.tools import demo_pipeline

    assert demo_pipeline.main(["--moves", "d2d4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "detected + committed: d2d4" in out and out.rstrip().endswith("OK")
