"""Recorded footage through the port (tools/process_video.py) vs the JAX tool.

One MJPG clip of a scripted two-move game (rendered with the fixtures,
written with cv2) goes through the JAX package's ``run`` and the port's
``run`` (device "cpu"; both sessions pick the Hough backend with ``auto``:
exact on the CPU). They must give the same moves, final FEN, frames
processed and JSONL timeline, with no cooldown and with a cooldown in video
seconds that drops the second move. ``run_capture`` fed the decoded frames
from memory (``FrameReader``, how footage reaches the card) equals ``run``
on the file. The committed clip tests/data/game_clip.avi plays to its
pinned timeline through the port.
"""

import hashlib
import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from chessboard_vision_tpu import rules as jrules
from chessboard_vision_tpu.rules import chess
from chessboard_vision_tpu.tools import process_video as jpv
from chessboard_vision_tpu_torch.session.drift import DriftMonitor
from chessboard_vision_tpu_torch.tools import process_video as tpv
from chessboard_vision_tpu_torch.tools.demo_pipeline import occupancy_of

from fixtures import DEFAULT_CORNERS, make_board_frame

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GAME_CLIP = os.path.join(HERE, "data", "game_clip.avi")
GAME_TIMELINE = os.path.join(HERE, "data", "game_clip_timeline.json")

CONFIG = {
    "corners": DEFAULT_CORNERS.tolist(),
    "player_color": "white",
    "orientation_flipped": False,
    "grid_lines_x": None,
    "grid_lines_y": None,
}
FPS = 30
# e2e4 shows on frame 4 and commits on frame 21 (20 stable frames); e7e5
# shows on frame 26 and commits on frame 45. A 2.0 s cooldown is 60 frames
# at 30 fps: it drops e7e5.
COOLDOWNS = {"no_cooldown": 0.0, "cooldown_2s": 2.0}
WANT_MOVES = {"no_cooldown": ["e2e4", "e7e5"], "cooldown_2s": ["e2e4"]}


def _frames():
    rng = np.random.default_rng(11)
    board = chess.Board()
    frames = [make_board_frame(occupancy_of(board), rng) for _ in range(4)]
    for uci, n in (("e2e4", 22), ("e7e5", 24)):
        board.push_uci(uci)
        frames += [make_board_frame(occupancy_of(board), rng) for _ in range(n)]
    return frames, board


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """(path, decoded frames, final board) of the scripted clip."""
    frames, board = _frames()
    path = str(tmp_path_factory.mktemp("clip") / "game.avi")
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), FPS, (w, h))
    assert vw.isOpened()
    for f in frames:
        vw.write(f)
    vw.release()
    cap = cv2.VideoCapture(path)
    decoded = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        decoded.append(img)
    cap.release()
    assert len(decoded) == len(frames)
    return path, decoded, board


@pytest.fixture(scope="module")
def runs(clip, tmp_path_factory):
    """Both tools' (result, JSONL lines) on the clip, per cooldown."""
    path, _, _ = clip
    tmp = tmp_path_factory.mktemp("timelines")
    out = {}
    for name, seconds in COOLDOWNS.items():
        for pkg, mod, kw in (("jax", jpv, {}), ("port", tpv, {"device": "cpu"})):
            timeline = str(tmp / f"{pkg}_{name}.jsonl")
            result = mod.run(path, dict(CONFIG), skip_frames=1, out_path=timeline,
                             cooldown_seconds=seconds, **kw)
            with open(timeline) as fh:
                out[pkg, name] = (result, fh.read().splitlines())
    return out


def test_parse_corners():
    assert tpv.parse_corners("1,2 3,4 5,6 7,8") == jpv.parse_corners("1,2 3,4 5,6 7,8")
    assert tpv.parse_corners("1,2 3,4 5,6 7,8") == [[1, 2], [3, 4], [5, 6], [7, 8]]
    with pytest.raises(ValueError):
        tpv.parse_corners("1,2 3,4")


@pytest.mark.parametrize("name", list(COOLDOWNS))
def test_run_matches_the_jax_tool(runs, clip, name):
    """The same moves, final FEN, frames processed and JSONL timeline (byte
    for byte) as the JAX tool; the cooldown in video seconds drops e7e5 in
    both."""
    (jmoves, jfen, jn), jlines = runs["jax", name]
    (tmoves, tfen, tn), tlines = runs["port", name]
    assert tmoves == jmoves == WANT_MOVES[name]
    assert (tfen, tn) == (jfen, jn)
    assert tlines == jlines
    assert json.loads(tlines[-1]) == {"final_fen": tfen, "moves": tmoves, "frames": tn}
    assert [json.loads(line)["frame"] for line in tlines[:-1]] == [21, 45][: len(tmoves)]
    if name == "no_cooldown":
        assert tfen == clip[2].fen()


def test_run_capture_from_memory_equals_run_on_the_file(runs, clip, tmp_path):
    """run_capture over the decoded frames held in memory (FrameReader at
    the clip's 30 fps) gives what run gives on the file, cooldown and all."""
    _, decoded, _ = clip
    timeline = str(tmp_path / "timeline.jsonl")
    reader = tpv.FrameReader(decoded, fps=FPS)
    assert tpv.CAP_PROP_FPS == cv2.CAP_PROP_FPS and reader.get(tpv.CAP_PROP_FPS) == FPS
    result = tpv.run_capture(reader, dict(CONFIG), skip_frames=1, out_path=timeline,
                             cooldown_seconds=COOLDOWNS["cooldown_2s"], device="cpu")
    with open(timeline) as fh:
        lines = fh.read().splitlines()
    assert (result, lines) == runs["port", "cooldown_2s"]
    assert reader.read() == (False, None)  # released


def test_main_writes_pgn_and_refuses_what_is_not_ported(clip, tmp_path, capsys, monkeypatch):
    """main --pgn on the CPU commits e2e4 within 24 processed frames and
    writes the PGN the JAX tool's main writes for it (the JAX rules' PGN
    with the same headers); compare_oracle without cv2 raises, naming cv2.
    --auto-recalibrate turns the session's drift checks on (the reference
    frame seeds the baseline) and digitizes the same game."""
    path, _, _ = clip
    corners = " ".join(f"{x},{y}" for x, y in DEFAULT_CORNERS)
    pgn = str(tmp_path / "game.pgn")
    assert tpv.main([path, "--corners", corners, "--skip-frames", "1", "--max-frames", "24",
                     "--pgn", pgn, "--device", "cpu"]) == 0
    with open(pgn) as fh:
        assert fh.read() == jrules.game_to_pgn(
            ["e2e4"], headers={"Event": "digitized recording"}, claim_draws=True)
    assert "1 moves over 24 processed frames" in capsys.readouterr().out
    checks = []
    check = DriftMonitor.check
    monkeypatch.setattr(DriftMonitor, "check",
                        lambda self, frame: checks.append(frame.shape) or check(self, frame))
    drift_pgn = str(tmp_path / "drift.pgn")
    assert tpv.main([path, "--corners", corners, "--skip-frames", "1", "--max-frames", "24",
                     "--pgn", drift_pgn, "--auto-recalibrate", "--device", "cpu"]) == 0
    assert checks == [(720, 1280, 3)]  # the baseline; the next check is due on frame 300
    with open(pgn) as fh, open(drift_pgn) as dfh:
        assert dfh.read() == fh.read()
    assert "1 moves over 24 processed frames" in capsys.readouterr().out
    # compare_oracle is ported (tests/test_torch_oracle.py); its oracle is
    # cv2, so where there is no cv2 it raises, naming cv2.
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        tpv.run_capture(tpv.FrameReader(clip[1]), dict(CONFIG), compare_oracle=True,
                        device="cpu")


def _decoded_clip_hash(path):
    cap = cv2.VideoCapture(path)
    h = hashlib.sha256()
    while True:
        ok, img = cap.read()
        if not ok:
            break
        h.update(img.tobytes())
    cap.release()
    return h.hexdigest()


def test_committed_game_clip_matches_pinned_timeline():
    """The committed MJPG clip (a two-move game on the hard renderer with a
    hand between the moves) plays to its pinned timeline through the port,
    as through the JAX tool (tests/test_process_video.py)."""
    with open(GAME_TIMELINE) as fh:
        pinned = json.load(fh)
    if _decoded_clip_hash(GAME_CLIP) != pinned["decoded_sha256"]:
        # Another OpenCV/libjpeg build decodes other pixels; a mismatch would
        # say nothing about this code (the JAX test's policy).
        pytest.skip("MJPG decodes differently from the pinning environment")
    moves, fen, n = tpv.run(GAME_CLIP, dict(CONFIG), skip_frames=1, device="cpu")
    assert moves == pinned["moves"]
    assert fen == pinned["final_fen"]
    assert n == pinned["frames_processed"]
