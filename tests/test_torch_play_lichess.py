"""The port's live driver (tools/play_lichess.py) from memory, no network.

The frame loop ``run`` takes any capture-like reader and key source: here
rendered 1280x720 frames of a game where white plays e2e4, a fake Lichess
client (no HTTP) and scripted keys, on the CPU. Polling inline (every
SKIP_FRAMES-th frame) and through the frame ring (a camera slower than the
step), the session commits e2e4 and the client receives its POST; 'k'
saves a checkpoint that resumes to the same position, 'c' re-captures the
reference, 'q' stops the loop with frames left; the PGN is written and the
stream thread ends. ``main`` runs with a stand-in for cv2's camera and
HighGUI (cv2's own drawing) and a calibration.json, with --no-ring, --pgn,
--checkpoint and --auto-recalibrate; its session is not headless and shows
the board overlay.
"""

import json
import sys
import threading
import time
import types

import cv2
import numpy as np
import pytest
import torch

from chessboard_vision_tpu_torch.rules import chess
from chessboard_vision_tpu_torch.session.lichess_session import LichessSession
from chessboard_vision_tpu_torch.tools import play_lichess as pl
from chessboard_vision_tpu_torch.tools.demo_pipeline import occupancy_of
from chessboard_vision_tpu_torch.tools.process_video import FrameReader

from fixtures import DEFAULT_CORNERS, make_board_frame

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

CONFIG = {"corners": np.asarray(DEFAULT_CORNERS).tolist(), "player_color": "white",
          "orientation_flipped": False}
WARMUP = 11  # capture_reference reads 10 frames, then the reference


class FakeClient:
    """The Board API surface LichessSession uses, in memory: every POST
    is accepted and recorded; the stream sends gameFull and idles."""

    def __init__(self):
        self.sent, self.my_color, self.clock, self.stream_ended = [], "white", None, False

    def connect(self):
        return True

    def get_ongoing_games(self):
        return [{"gameId": "g1"}]

    def make_move(self, uci):
        self.sent.append(uci)
        return True

    def is_my_turn(self, moves):
        return (len(moves.split()) if moves else 0) % 2 == 0

    def get_last_move(self, moves):
        return moves.split()[-1] if moves else None

    def handle_draw_offer(self, accept):
        return True

    def stream_game_with_reconnect(self, game_id, stop_check=None):
        yield {"type": "gameFull", "state": {"moves": "", "status": "started"}}
        while not stop_check():
            time.sleep(0.01)
        self.stream_ended = True


class QuickSession(LichessSession):
    """A short stability window and no cooldown: a move commits in a few
    frames (the JAX session tests' settings)."""

    STABILITY_REQUIRED = 4
    MOVE_COOLDOWN = 0.0


def _frames(n_start=4, n_moved=24):
    """WARMUP start frames for the calibration, then the game: n_start more
    on the start position, n_moved after e2e4."""
    rng = np.random.default_rng(17)
    board = chess.Board()
    frames = [make_board_frame(occupancy_of(board), rng) for _ in range(WARMUP + n_start)]
    board.push_uci("e2e4")
    frames += [make_board_frame(occupancy_of(board), rng) for _ in range(n_moved)]
    return frames, board


def _connected(cap):
    session = QuickSession(client=FakeClient(), device="cpu")
    assert session.on_calibration_requested(cap, config=dict(CONFIG))
    assert session.connect_and_setup(interactive=False)
    assert session.game_id == "g1" and session.my_color == "white"
    return session


class KeyScript:
    """cv2.waitKey stand-in: after the session's n-th processed frame, the
    key scripted for n (once); polls between steps read nothing."""

    def __init__(self, session, keys):
        self.keys, self.stepped = dict(keys), False
        on_frame = session.on_frame

        def stepping(img):
            self.stepped = True
            return on_frame(img)

        session.on_frame = stepping
        self.session = session

    def __call__(self, ms):
        key = -1
        if self.stepped:
            key = ord(self.keys.pop(self.session.frame_count, "\xff"))
        self.stepped = False
        return key


def test_loop_inline_commits_posts_and_keys(tmp_path):
    """--no-ring: every SKIP_FRAMES-th frame is stepped (the others shown);
    'c' at step 1 re-captures the reference, 'k' at step 2 checkpoints,
    e2e4 commits and is POSTed, 'q' stops the loop with frames left."""
    frames, board = _frames()
    cap = FrameReader(frames)
    session = _connected(cap)
    recaptured = []
    capture = session.capture_reference_frame
    session.capture_reference_frame = lambda img: (recaptured.append(img), capture(img))
    keys = KeyScript(session, {1: "c", 2: "k", 12: "q"})
    shown = []
    ckpt, pgn = str(tmp_path / "k.npz"), str(tmp_path / "game.pgn")
    result = pl.run(session, cap, keys, show=lambda name, img: shown.append(name),
                    use_ring=False, checkpoint=ckpt, pgn=pgn)
    assert result == pl.LoopResult(12, 0, 0)
    assert len(shown) == 12 and set(shown) == {"Camera"}  # the skipped frames
    assert cap.read() == (False, None)  # released with frames left
    assert len(recaptured) == 1 and recaptured[0] is frames[WARMUP + 1]
    assert session.lichess.sent == ["e2e4"]
    assert session.game.get_fen() == board.fen()
    with open(pgn) as fh:
        assert "1. e4 *" in fh.read()
    session._stream_thread.join(timeout=5)
    assert session.stop_event.is_set() and session.lichess.stream_ended
    resumed = QuickSession(client=FakeClient(), device="cpu")
    resumed.resume_checkpoint(ckpt)
    assert resumed.game.get_fen() == chess.Board().fen() and resumed.frame_count == 2


class PacedReader(FrameReader):
    """A camera slower than the step: once paced, each read waits until
    the loop has stepped the last frame; afterwards it reports no frame."""

    def __init__(self, frames):
        super().__init__(frames)
        self.paced, self.stepped = False, threading.Event()
        self.done = threading.Event()

    def read(self):
        if self.paced:
            self.stepped.wait(timeout=60)
            self.stepped.clear()
        ok, img = super().read()
        if not ok:
            self.done.set()
            time.sleep(0.01)
        return ok, img


def test_loop_with_ring_commits_and_posts(tmp_path):
    """The default route: a capture thread feeds the frame ring, the loop
    steps the newest frame; with a camera slower than the step nothing is
    dropped, e2e4 commits and is POSTed, and 'q' once the camera has
    nothing left ends the loop and the capture thread."""
    frames, board = _frames(n_start=2, n_moved=14)
    cap = PacedReader(frames)
    session = _connected(cap)
    on_frame = session.on_frame

    def stepped(img):
        move = on_frame(img)
        cap.stepped.set()
        return move

    session.on_frame = stepped
    cap.paced = True
    cap.stepped.set()  # the first frame is due at once

    def wait_key(ms):
        return ord("q") if cap.done.is_set() else -1

    pgn = str(tmp_path / "game.pgn")
    before = set(threading.enumerate())
    result = pl.run(session, cap, wait_key, use_ring=True, pgn=pgn)
    assert result == pl.LoopResult(16, 0, 0)
    assert session.lichess.sent == ["e2e4"]
    assert session.game.get_fen() == board.fen()
    session._stream_thread.join(timeout=5)
    assert not [t for t in threading.enumerate() if t not in before and t.is_alive()]
    with open(pgn) as fh:
        assert "1. e4 *" in fh.read()


class FakeCamera(FrameReader):
    """cv2.VideoCapture's surface main() uses."""

    def __init__(self, frames):
        super().__init__(frames)
        self.props = {}

    def set(self, prop, value):
        self.props[prop] = value

    def isOpened(self):
        return True


def test_main_runs_the_loop_with_a_camera_and_calibration_file(monkeypatch, tmp_path):
    """main() with a stand-in for cv2 (camera, waitKey, imshow) and a
    calibration.json in the working directory: --no-ring --auto-recalibrate
    --pgn --checkpoint; the player picks the listed game, the session gets
    its drift monitor, commits and POSTs e2e4, and the PGN is written when
    the camera runs out."""
    monkeypatch.chdir(tmp_path)
    with open("calibration.json", "w") as fh:
        json.dump(CONFIG, fh)
    frames, board = _frames()
    camera = FakeCamera(frames)
    closed = []
    shown = []
    drawing = {name: getattr(cv2, name) for name in (
        "line", "putText", "rectangle", "circle", "addWeighted", "FONT_HERSHEY_SIMPLEX")}
    monkeypatch.setitem(sys.modules, "cv2", types.SimpleNamespace(
        VideoCapture=lambda index: camera, waitKey=lambda ms: -1,
        imshow=lambda name, img: shown.append((name, img.shape)),
        destroyAllWindows=lambda: closed.append(True), **drawing))
    sessions = []

    def make(**kw):
        sessions.append(QuickSession(client=FakeClient(), **kw))
        return sessions[-1]

    monkeypatch.setattr(pl, "LichessSession", make)
    monkeypatch.setattr("builtins.input", lambda prompt="": "1")  # the listed game
    assert pl.main(["--no-ring", "--auto-recalibrate", "--pgn", "game.pgn", "--checkpoint",
                    "k.npz", "--device", "cpu"]) == 0
    (session,) = sessions
    assert camera.props == {3: pl.WIDTH, 4: pl.HEIGHT} and closed == [True]
    # headless=False: every stepped frame shows the board overlay (the
    # session's warped 620 px board) and the camera, as the JAX play_lichess does;
    # polling inline, the loop shows the SKIP_FRAMES - 1 others' camera too.
    boards = shown.count(("Board", (620, 620, 3)))
    assert not session.headless and boards >= 4
    assert shown.count(("Camera", (720, 1280, 3))) == pl.SKIP_FRAMES * boards
    assert session.drift is not None and session.config["auto_recalibrate"]
    assert session.lichess.sent == ["e2e4"] and session.game.get_fen() == board.fen()
    with open("game.pgn") as fh:
        assert "1. e4 *" in fh.read()


def test_ring_is_the_default_and_raises_without_a_build(monkeypatch):
    """No silent fallback: when the ring cannot be built the loop raises
    (the caller asks for --no-ring to poll inline)."""

    def broken_ring(shape, n_slots):
        raise RuntimeError("g++ could not build the frame ring")

    monkeypatch.setattr(pl, "FrameRing", broken_ring)
    session = types.SimpleNamespace(stop_event=threading.Event())
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        pl.run(session, FrameReader([]), lambda ms: -1)
