"""The port's convenience API (chessboard_vision_tpu_torch.api) vs the JAX
package's (chessboard_vision_tpu.api), on the CPU.

Both sides get the same frames: tests/test_api.py's ``frame_pair`` (the
start position, then e2e4) and renders with per-type piece radii. Both
pipelines pick the Hough backend with ``auto``: exact on the CPU. Occupancy
sets, FENs (occupancy and full), changed squares, moves and PGN must be
equal. Where pixels pass through f32 arithmetic the tolerance is stated at
the test.
"""

import functools
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import chessboard_vision_tpu as cbv
import chessboard_vision_tpu_torch as tv
from chessboard_vision_tpu import api as japi
from chessboard_vision_tpu.ops import enhance as jenh
from chessboard_vision_tpu.ops.pallas import bilateral as jbil
from chessboard_vision_tpu.rules import chess
from chessboard_vision_tpu_torch import api as tapi
from chessboard_vision_tpu_torch.models import pipeline as tp
from jax.experimental.pallas import tpu as pltpu

from fixtures import DEFAULT_CORNERS, board_render_maps, initial_occupancy, make_board_frame

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIDGAME_FEN = "r1bqkbnr/pppp1ppp/2n5/4p3/4P3/5N2/PPPP1PPP/RNBQKB1R w KQkq - 4 3"


@pytest.fixture(scope="module")
def frame_pair():
    """tests/test_api.py's frames: the start position, then e2e4."""
    rng = np.random.default_rng(77)
    occ0 = initial_occupancy()
    occ1 = occ0.copy()
    occ1[4, 1] = False
    occ1[4, 3] = True  # e2e4
    return make_board_frame(occ0, rng), make_board_frame(occ1, rng), occ1


def test_lazy_exports():
    """The package's lazy attributes are api's entry points and the main
    classes; importing the package alone imports neither torch nor api."""
    for name in ("enhance_frame", "extract_grid", "detect_pieces", "detect_changes",
                 "frame_to_fen", "frame_to_full_fen", "digitize_video", "generate_fen",
                 "occupancy_to_fen", "occupancy_to_colored_fen"):
        assert getattr(tv, name) is getattr(tapi, name)
    assert tv.VisionPipeline is tp.VisionPipeline
    assert tv.GameSession.__name__ == "GameSession" and tv.BoardGeometry.__name__ == "BoardGeometry"
    with pytest.raises(AttributeError):
        tv.nonexistent_thing
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chessboard_vision_tpu_torch; "
         "assert not {'torch', 'chessboard_vision_tpu_torch.api'} & set(sys.modules)"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_detect_pieces_and_frame_to_fen_equal_jax(frame_pair):
    f0, f1, occ1 = frame_pair
    want = cbv.detect_pieces(f1, DEFAULT_CORNERS, reference_frame=f0)
    got = tv.detect_pieces(f1, DEFAULT_CORNERS, reference_frame=f0, device="cpu")
    assert got == want == {(f, r) for f in range(8) for r in range(8) if occ1[f, r]}
    for ref in (f0, None):  # with and without a visual reference
        assert tv.frame_to_fen(f1, DEFAULT_CORNERS, reference_frame=ref, device="cpu") == \
            cbv.frame_to_fen(f1, DEFAULT_CORNERS, reference_frame=ref)
    assert tv.frame_to_fen(f1, DEFAULT_CORNERS, reference_frame=f0, device="cpu").split()[0] == \
        "PPPPPPPP/PPPPPPPP/8/8/4P3/8/PPPP1PPP/PPPPPPPP"


def test_detect_changes_equal_jax(frame_pair):
    f0, f1, _ = frame_pair
    got = tv.detect_changes(f1, DEFAULT_CORNERS, reference_frame=f0, device="cpu")
    assert got == cbv.detect_changes(f1, DEFAULT_CORNERS, reference_frame=f0)
    assert (4, 1) in got and (4, 3) in got and len(got) <= 8


def test_cached_state_is_never_written(frame_pair):
    """The api hands one cached initial state to every call: after calls
    that capture references and step, it still equals a fresh init_state."""
    f0, f1, _ = frame_pair
    tv.detect_changes(f1, DEFAULT_CORNERS, reference_frame=f0, device="cpu")
    tv.detect_pieces(f1, DEFAULT_CORNERS, reference_frame=f0, device="cpu")
    pipe, state = tapi._pipeline_for(DEFAULT_CORNERS, None, "cpu")
    for got, fresh in zip(tp.state_to_numpy(state), tp.state_to_numpy(pipe.init_state())):
        for a, b in zip(got, fresh):
            np.testing.assert_array_equal(a, b)


def test_frame_to_full_fen_equals_jax():
    """Calibrated on two frames of the start position, read on two frames
    of a midgame position (tests/test_piece_types.py's): the same full FEN
    as the JAX api."""
    rng = np.random.default_rng(5)

    def frame(board):
        occ, colors, radii = board_render_maps(board)
        return make_board_frame(occ, rng, piece_colors=colors, piece_radii=radii)

    start, target = chess.Board(), chess.Board(MIDGAME_FEN)
    cal = [frame(start) for _ in range(2)]
    frames = [frame(target) for _ in range(2)]
    want = cbv.frame_to_full_fen(frames[0], DEFAULT_CORNERS, cal, frames=frames[1:])
    got = tv.frame_to_full_fen(frames[0], DEFAULT_CORNERS, cal, frames=frames[1:], device="cpu")
    assert got == want
    assert got.split()[0].count("/") == 7


# Queue C 7's limits for the whole enhancement (tests/test_torch_enhance.py):
# one-level differences of the f32 stages pass through the sharpen, so a
# pixel may differ by up to 9 levels on at most 1e-3 of the pixels.
ENHANCE_MAX_DIFF, ENHANCE_FRACTION = 9, 1e-3


def test_enhance_frame_equals_jax_with_its_tpu_kernels(frame_pair, monkeypatch):
    """api.enhance_frame on a 240x320 crop against the JAX api with its TPU
    kernels (the bilateral and CLAHE Pallas kernels in interpret mode, as
    the JAX package's own CPU tests run them): within Queue C 7's limits
    (measured: bit-equal)."""
    small = np.ascontiguousarray(frame_pair[0][:240, :320])
    monkeypatch.setattr(japi, "_enhancers", {})
    monkeypatch.setattr(jenh, "clahe", functools.partial(jenh.clahe, backend="pallas"))
    monkeypatch.setattr(jbil, "bilateral_planar_best", jbil.bilateral_planar_pallas)
    with pltpu.force_tpu_interpret_mode():
        want = cbv.enhance_frame(small)
    got = tv.enhance_frame(small, device="cpu")
    assert got.shape == small.shape and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= ENHANCE_MAX_DIFF and (d > 0).mean() <= ENHANCE_FRACTION, (
        d.max(), (d > 0).mean())
    assert not np.array_equal(got, small)


# cv2.warpPerspective blends with 5-bit fixed-point bilinear weights; the
# gather warp lerps in f32 and rounds once. Measured on the frame pair: 1
# level at most, on 2.2e-4 of the crops' pixels.
GRID_MAX_DIFF, GRID_FRACTION = 1, 1e-3


@pytest.mark.parametrize("pad", [(0, 0), (360, 640)], ids=["1280x720", "1920x1080"])
def test_extract_grid_matches_jax(frame_pair, pad):
    """The same crops as the JAX api, whose geometry assumes a 1280x720
    capture whatever the frame's size: on a 1080p frame (the 720p frame
    with a black border at the bottom and right) the board is still 620 px."""
    f0 = np.pad(frame_pair[0], ((0, pad[0]), (0, pad[1]), (0, 0)))
    want = cbv.extract_grid(f0, DEFAULT_CORNERS)
    got = tv.extract_grid(f0, DEFAULT_CORNERS, device="cpu")
    assert set(got) == set(want) == {(f, r) for f in range(8) for r in range(8)}
    differ = total = 0
    for key, crop in got.items():
        assert crop.shape == want[key].shape and crop.dtype == np.uint8
        d = np.abs(crop.astype(int) - want[key].astype(int))
        assert d.max() <= GRID_MAX_DIFF, (key, d.max())
        differ, total = differ + int((d > 0).sum()), total + d.size
    assert differ / total <= GRID_FRACTION, differ / total
    lines = [0, 70, 155, 232, 310, 388, 466, 544, 620]  # a smart grid's lines
    got = tv.extract_grid(f0, DEFAULT_CORNERS, grid_x=lines, grid_y=lines, device="cpu")
    want = cbv.extract_grid(f0, DEFAULT_CORNERS, grid_x=lines, grid_y=lines)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}


def test_reexports_equal_jax():
    detections = [
        {"center": (30, 30), "class": "white-rook", "conf": 0.9},
        {"center": (100, 30), "class": "black-king", "conf": 0.8},
    ]
    board_map = tapi.map_detections_to_board(detections, board_size=620)
    assert board_map == japi.map_detections_to_board(detections, board_size=620)
    assert tv.generate_fen(board_map) == cbv.generate_fen(board_map)
    assert tv.generate_fen(board_map).split()[0] == "Rk6/8/8/8/8/8/8/8"


def test_digitize_video_equals_jax(tmp_path):
    """One call from an MJPG file: the same moves, FEN, PGN and frame count
    as the JAX api (tests/test_api.py's clip)."""
    rng = np.random.default_rng(11)
    occ0 = initial_occupancy()
    occ1 = occ0.copy()
    occ1[4, 1] = False
    occ1[4, 3] = True
    frames = [make_board_frame(occ0, rng) for _ in range(8)]
    frames += [make_board_frame(occ1, rng) for _ in range(26)]
    path = str(tmp_path / "game.avi")
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (w, h))
    assert vw.isOpened()
    for f in frames:
        vw.write(f)
    vw.release()
    headers = {"Event": "api test"}
    want = cbv.digitize_video(path, corners=DEFAULT_CORNERS, skip_frames=1, pgn_headers=headers)
    got = tv.digitize_video(path, corners=DEFAULT_CORNERS, skip_frames=1, pgn_headers=headers,
                            device="cpu")
    assert got == want
    assert got["moves"] == ["e2e4"] and "1. e4 *" in got["pgn"] and got["frames"] > 20
    # Drift checks on (no bump in this clip: the same game).
    assert tv.digitize_video(path, corners=DEFAULT_CORNERS, skip_frames=1, pgn_headers=headers,
                             auto_recalibrate=True, device="cpu") == want


def test_entry_points_need_the_card_unless_asked_for_the_cpu(frame_pair):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    for call in (lambda: tv.detect_pieces(frame_pair[0], DEFAULT_CORNERS),
                 lambda: tv.enhance_frame(frame_pair[0][:64, :64]),
                 lambda: tv.extract_grid(frame_pair[0], DEFAULT_CORNERS)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
