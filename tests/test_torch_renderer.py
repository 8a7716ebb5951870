"""The board renderer and the session's UI surface vs the JAX package.

``session/renderer.py`` draws with cv2 on a host image in both packages:
the port's image must be bit-equal to the JAX renderer's for the smart and
the linear grid, the noise overlay, the last move, the lifted piece, the
radar, both colours' glyphs, the FPS and the clock text, and for the grid
labels of both orientations. The sessions: the ``compat_visual_rank_quirk``
smart-scan set equals the JAX one with the quirk on and off, and
``GameSession(headless=False)`` in both packages, on the same frames (the
e2 pawn lifted after two frames), sets the same lifted square and radar
each frame and shows the same "Board" and "Camera" images (cv2.imshow
recorded; the FPS counter held fixed in both, its value is wall time).
"""

import threading

import cv2
import numpy as np
import pytest
import torch

from chessboard_vision_tpu.models.pipeline import VisionPipeline as JaxPipeline
from chessboard_vision_tpu.rules import GameState as JaxGameState
from chessboard_vision_tpu.session import game_session as jsess
from chessboard_vision_tpu.session import renderer as jrender
from chessboard_vision_tpu_torch.rules import GameState
from chessboard_vision_tpu_torch.session import renderer as trender
from chessboard_vision_tpu_torch.session.game_session import GameSession

from fixtures import DEFAULT_CORNERS, initial_occupancy, make_board_frame, render_board_image

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
BOARD = 620
SMART_GRID = [0, 80, 155, 232, 310, 388, 466, 544, 620]


def _games(ucis):
    games = JaxGameState(), GameState()
    for g in games:
        for uci in ucis:
            g.board.push_uci(uci)
    return games


CASES = {
    "linear_grid_start": dict(moves=(), grid=False, kw={}),
    "smart_grid_hud": dict(moves=("e2e4",), grid=True,
                           kw=dict(fps=29.97, clock_text="W 04:58 | B 05:00")),
    "noise_last_move": dict(moves=("e2e4", "e7e5"), grid=False, kw=dict(noise_active=True)),
    "lifted_radar": dict(moves=("e2e4", "e7e5"), grid=True,
                         kw=dict(lifted=(6, 0), radar=[(5, 2), (7, 2), (4, 1)], fps=8.0)),
    "black_to_move_captures": dict(moves=("e2e4", "d7d5", "e4d5", "d8d5"), grid=False,
                                   kw=dict(lifted=(3, 4), radar=[(3, 1), (0, 4)],
                                           clock_text="x")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_board_overlay_bit_equal(case):
    """draw_board_overlay on a rendered top-down board: the port's image is
    the JAX renderer's, byte for byte."""
    c = CASES[case]
    jgame, tgame = _games(c["moves"])
    base = render_board_image(initial_occupancy(), np.random.default_rng(1), board_px=BOARD)
    grid = (SMART_GRID, SMART_GRID) if c["grid"] else (None, None)
    want = jrender.draw_board_overlay(base.copy(), BOARD, *grid, jgame, threading.RLock(),
                                      **c["kw"])
    got = trender.draw_board_overlay(base.copy(), BOARD, *grid, tgame, threading.RLock(),
                                     **c["kw"])
    assert not np.array_equal(got, base)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("orientation", ["WHITE", "BLACK"])
def test_grid_labels_bit_equal(orientation):
    base = render_board_image(initial_occupancy(), np.random.default_rng(2), board_px=BOARD)
    want = jrender.draw_chess_grid_dynamic(base.copy(), BOARD, orientation)
    np.testing.assert_array_equal(trender.draw_chess_grid_dynamic(base.copy(), BOARD, orientation),
                                  want)


@pytest.mark.parametrize("quirk", [False, True], ids=["fixed", "visual_rank_quirk"])
def test_smart_scan_set_equals_jax(quirk):
    """The smart-scan set (occupied squares + legal destinations) with and
    without the reference's visual-rank quirk, along a short game."""
    jsession = jsess.GameSession(headless=True, compat_visual_rank_quirk=quirk)
    tsession = GameSession(device="cpu", compat_visual_rank_quirk=quirk)
    jsession.game, tsession.game = _games(())
    for uci in ("", "e2e4", "g8f6", "g1f3"):
        if uci:
            jsession.game.board.push_uci(uci)
            tsession.game.board.push_uci(uci)
        got = tsession._smart_scan_set()
        assert got == jsession._smart_scan_set()
    assert ((4, 2) in got) == quirk  # e7e6 lands on e3 in visual ranks


class _FixedFps:
    fps = 12.5

    def update(self):
        return self.fps


def test_headless_false_session_shows_the_jax_board_and_radar(monkeypatch):
    """Both packages' GameSession(headless=False) on the same frames: the
    same lifted square and radar destinations each frame (e2 lifted: its
    destinations e3 and e4) and the same "Board" and "Camera" images."""
    method = JaxPipeline.warp_board  # read-only in this jax (ROADMAP Queue C 18)
    monkeypatch.setattr(JaxPipeline, "warp_board",
                        lambda self, frame: np.array(method(self, frame), copy=True))
    shown = []
    monkeypatch.setattr(cv2, "imshow", lambda window, img: shown.append((window, img.copy())))
    rng = np.random.default_rng(17)
    occ = initial_occupancy()
    lifted = occ.copy()
    lifted[4, 1] = False
    ref = make_board_frame(occ, rng)
    frames = [make_board_frame(occ, rng) for _ in range(2)]
    frames += [make_board_frame(lifted, rng) for _ in range(5)]
    sessions = {"jax": jsess.GameSession(headless=False),
                "port": GameSession(device="cpu", headless=False)}
    radar, images = {}, {}
    for name, session in sessions.items():
        assert session.on_calibration_requested(None, config=dict(CONFIG))
        session.capture_reference_frame(ref)
        session.fps = _FixedFps()
        radar[name] = []
        del shown[:]
        for fr in frames:
            assert session.on_frame(fr) is None
            radar[name].append((session.lifted_piece_square,
                                sorted(session.current_radar_destinations)))
        images[name] = list(shown)
    assert radar["port"] == radar["jax"]
    assert radar["port"][0] == (None, [])
    assert radar["port"][-1] == ((4, 1), [(4, 2), (4, 3)])
    assert [w for w, _ in images["port"]] == ["Board", "Camera"] * len(frames)
    for i, ((_, want), (_, got)) in enumerate(zip(images["jax"], images["port"])):
        np.testing.assert_array_equal(got, want, err_msg=f"image {i}")
