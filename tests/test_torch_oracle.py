"""The cv2 oracles of the port's reference/ and ``--compare-oracle`` vs the JAX package.

``process_video.run(compare_oracle=True)`` replays the processed frames of
an MJPG clip (built as tests/test_process_video.py builds its oracle clip,
cut to 24 processed frames) through the cv2 oracle's decision loop beside
the session, in both packages (the port on the CPU; both sessions take the
exact Hough backend there): the same moves, the same report and the same
JSONL timeline, ``{"oracle_comparison": ...}`` record included, byte for
byte. ``main --compare-oracle`` prints the report. Without cv2 (the card's
machine) the comparison raises an ImportError that names cv2; the oracle
modules themselves still import. Each oracle class of the port equals the
JAX one on the same squares and frames.
"""

import json
import os
import pathlib
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from chessboard_vision_tpu import geometry as jgeo
from chessboard_vision_tpu.reference import ChangeDetectorCV as JaxChange
from chessboard_vision_tpu.reference import ImageEnhancerCV as JaxEnhancer
from chessboard_vision_tpu.reference import PieceDetectorCV as JaxPiece
from chessboard_vision_tpu.rules import chess
from chessboard_vision_tpu.tools import process_video as jpv
from chessboard_vision_tpu_torch.reference import ChangeDetectorCV, ImageEnhancerCV, PieceDetectorCV
from chessboard_vision_tpu_torch.tools import process_video as tpv
from chessboard_vision_tpu_torch.tools.demo_pipeline import occupancy_of

from fixtures import DEFAULT_CORNERS, initial_occupancy, make_board_frame

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

CONFIG = {
    "corners": [list(map(int, c)) for c in DEFAULT_CORNERS],
    "player_color": "white",
    "orientation_flipped": False,
    "grid_lines_x": None,
    "grid_lines_y": None,
}
MAX_FRAMES = 24
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """An MJPG clip of e2e4: 4 frames of the start position, then 24."""
    rng = np.random.default_rng(13)
    board = chess.Board()
    frames = [make_board_frame(occupancy_of(board), rng) for _ in range(4)]
    board.push_uci("e2e4")
    frames += [make_board_frame(occupancy_of(board), rng) for _ in range(MAX_FRAMES)]
    path = str(tmp_path_factory.mktemp("clip") / "clip.avi")
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (w, h))
    assert vw.isOpened()
    for f in frames:
        vw.write(f)
    vw.release()
    return path, board


def test_compare_oracle_record_equals_jax(clip, tmp_path):
    """The same (moves, FEN, frames, report) and the same JSONL lines; the
    report's keys are the JAX tool's file format."""
    path, board = clip
    out = {}
    for pkg, mod, kw in (("jax", jpv, {}), ("port", tpv, {"device": "cpu"})):
        timeline = str(tmp_path / f"{pkg}.jsonl")
        result = mod.run(path, dict(CONFIG), skip_frames=1, out_path=timeline,
                         max_frames=MAX_FRAMES, compare_oracle=True, **kw)
        with open(timeline) as fh:
            out[pkg] = result, fh.read().splitlines()
    (moves, fen, n, report), lines = out["port"]
    assert out["port"] == out["jax"]
    assert moves == ["e2e4"] and fen == board.fen() and n == MAX_FRAMES
    assert json.loads(lines[-1]) == {"oracle_comparison": report}
    assert list(report) == ["frames_compared", "square_agreement_pct",
                            "frame_full_agreement_pct", "tpu_moves", "oracle_moves",
                            "move_lists_match", "first_divergent_move", "tpu_final_fen",
                            "oracle_final_fen", "fen_match"]
    assert report["frames_compared"] == n and report["square_agreement_pct"] >= 99.0


def test_main_prints_the_oracle_report(clip, capsys):
    path, _ = clip
    corners = " ".join(f"{x},{y}" for x, y in DEFAULT_CORNERS)
    assert tpv.main([path, "--corners", corners, "--skip-frames", "1", "--max-frames",
                     str(MAX_FRAMES), "--compare-oracle", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "oracle comparison (cv2 decision loop on the same frames):" in printed
    assert "per-square occupancy agreement:" in printed and "final FEN match:" in printed


def test_compare_oracle_without_cv2_names_it():
    """As on the card's machine: the reference package imports without cv2,
    and asking for the comparison raises an ImportError naming cv2 before
    any frame is processed."""
    script = r"""
import sys
sys.modules["cv2"] = None
import numpy as np
from chessboard_vision_tpu_torch.reference import PieceDetectorCV
from chessboard_vision_tpu_torch.reference.replay_session import OracleReplaySession
from chessboard_vision_tpu_torch.tools import process_video
frames = [np.zeros((720, 1280, 3), np.uint8)] * 4
config = {"corners": [[260, 80], [1020, 95], [240, 640], [1035, 655]]}
try:
    process_video.run_capture(process_video.FrameReader(frames), config, device="cpu",
                              compare_oracle=True)
except ImportError as e:
    assert "cv2" in str(e), e
    print("NAMES_CV2")
"""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "NAMES_CV2" in proc.stdout


def _squares(seed, moved=False):
    """The linear squares of a warped fixture frame (the start position, or
    after e2e4), and the frame."""
    rng = np.random.default_rng(seed)
    occ = initial_occupancy()
    if moved:
        occ[4, 1], occ[4, 3] = False, True
    frame = make_board_frame(occ, rng)
    M, bs = jgeo.warp_matrix(jgeo.reorder(DEFAULT_CORNERS))
    return jgeo.split_board_dict(cv2.warpPerspective(frame, M, (bs, bs))), frame


def test_piece_and_change_oracles_equal_jax():
    """PieceDetectorCV's per-square results (one call, then the cached and
    smoothed batch API) and ChangeDetectorCV's detailed changes and hand
    pattern on the same squares."""
    ref, _ = _squares(1)
    moved, _ = _squares(2, moved=True)
    settings = {"min_radius": 15, "max_radius": 60}
    jp, tp = JaxPiece(settings), PieceDetectorCV(settings)
    for pos in sorted(ref):
        assert tp.detect_piece(ref[pos], pos) == jp.detect_piece(ref[pos], pos), pos
    jp.calibrate_reference(ref)
    tp.calibrate_reference(ref)
    for squares in (moved, ref, moved):
        assert tp.detect_all_pieces(squares) == jp.detect_all_pieces(squares)
    assert tp.get_occupied_squares(moved) == jp.get_occupied_squares(moved)
    jc, tc = JaxChange(), ChangeDetectorCV()
    for c in (jc, tc):
        c.calibrate(ref)
        c.update_all_references(ref)
    detailed = tc.detect_changes_detailed(moved)
    assert detailed == jc.detect_changes_detailed(moved) and {(4, 1), (4, 3)} <= set(detailed)
    assert tc.detect_changes(moved) == jc.detect_changes(moved)
    assert tc.classify_hand_pattern(detailed) == jc.classify_hand_pattern(detailed)


def test_enhancer_oracle_equals_jax():
    _, frame = _squares(3, moved=True)
    profile = {"hue_shift": 7, "sat_scale": 1.2, "contrast": 1.3, "brightness": -7,
               "radical_mode": 1, "target_hue": 20, "hue_window": 25}
    je, te = JaxEnhancer(profile=profile), ImageEnhancerCV(profile=profile)
    crop = np.ascontiguousarray(frame[200:440, 400:720])
    np.testing.assert_array_equal(te.process_pipeline(crop), je.process_pipeline(crop))
    for a, b in zip(te.prepare_analysis(crop), je.prepare_analysis(crop)):
        np.testing.assert_array_equal(a, b)
