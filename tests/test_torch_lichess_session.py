"""The port's LichessSession (session/lichess_session.py), no network.

Mirrors tests/test_race_condition.py: a mock client whose make_move fires
the server's echo (``_sync_moves``) from another thread while the vision
thread still holds the commit path; board_lock and the double-checked sync
must leave exactly one move on the board. Also the LichessSession tests of
tests/test_session_fixes.py (from-position sync, a bad server move, a game
finished at join, draw claims and the lock discipline of their POST, the
server's result in the PGN, the terminal event's final move) and
tests/test_pgn.py (%clk annotations), each run against the port, and one
event stream through both packages' sessions: the same board, PGN and
flags.
"""

import logging
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from chessboard_vision_tpu.net.lichess_client import ClockState as JaxClock
from chessboard_vision_tpu.session.lichess_session import LichessSession as JaxLichessSession
from chessboard_vision_tpu_torch.net.lichess_client import ClockState
from chessboard_vision_tpu_torch.rules import GameState, chess
from chessboard_vision_tpu_torch.rules.chesslib import Move
from chessboard_vision_tpu_torch.session.lichess_session import LichessSession
from chessboard_vision_tpu_torch.session.noise import NoiseHandler

from fixtures import DEFAULT_CORNERS

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

CONFIG = {"corners": np.asarray(DEFAULT_CORNERS).tolist(), "player_color": "white",
          "orientation_flipped": False}


class MockLichessClient:
    """make_move succeeds and concurrently fires the server echo."""

    def __init__(self):
        self.sent = []
        self.session = None
        self.my_color = "white"
        self.echo_threads = []

    def make_move(self, uci):
        self.sent.append(uci)

        def echo():
            # The server echoes the move list while the vision thread is
            # still inside its commit critical section.
            self.session._sync_moves(uci)

        t = threading.Thread(target=echo)
        t.start()
        self.echo_threads.append(t)
        time.sleep(0.05)  # let the echo thread reach the lock
        return True

    def is_my_turn(self, moves_str):
        return len(moves_str.split()) % 2 == 0 if moves_str else True

    def get_last_move(self, moves_str):
        moves = moves_str.split() if moves_str else []
        return moves[-1] if moves else None


def make_session():
    s = LichessSession(client=MockLichessClient(), device="cpu")
    s.lichess.session = s
    s.game = GameState()
    s.noise = NoiseHandler()
    # No vision stack: the tests drive _process_stable_move directly.
    s.pipeline = None
    s._refresh_next = False
    s.stable_count = 0
    s.stable_occupancy = None
    s.last_move_time = 0.0
    return s


def test_commit_vs_stream_echo_race():
    s = make_session()
    occ = s.game.get_board_occupancy()  # vision sees e2 -> e4, stable long enough
    occ.discard((4, 1))
    occ.add((4, 3))
    s.stable_occupancy = set(occ)
    s.stable_count = s.STABILITY_REQUIRED  # increments to REQUIRED + 1

    move = s._process_stable_move(occ, noise_state=None)
    for t in s.lichess.echo_threads:
        t.join(timeout=2)
        assert not t.is_alive()

    assert move is not None and move.uci() == "e2e4"
    assert s.lichess.sent == ["e2e4"]
    # Exactly one move on the board: the echo did not apply it again.
    assert len(s.game.board.move_stack) == 1
    assert s.game.board.peek().uci() == "e2e4"
    assert s.last_lichess_moves == "e2e4"
    assert s.waiting_for_opponent


def test_opponent_move_applies_via_sync():
    s = make_session()
    s._sync_moves("e2e4 e7e5")
    assert len(s.game.board.move_stack) == 2
    assert s.game.board.peek().uci() == "e7e5"
    assert not s.waiting_for_opponent  # our turn again (white)


def test_sync_is_idempotent():
    s = make_session()
    s._sync_moves("e2e4")
    fen1 = s.game.get_fen()
    s._sync_moves("e2e4")
    assert s.game.get_fen() == fen1
    assert len(s.game.board.move_stack) == 1


def test_not_my_turn_rejects_local_move():
    s = make_session()
    s.waiting_for_opponent = True
    assert not s.on_move_detected(chess.Move.from_uci("e2e4"))
    assert s.lichess.sent == []


def _bare_lichess_session():
    s = LichessSession.__new__(LichessSession)
    s.game = GameState()
    s.log = logging.getLogger("test")
    s.last_lichess_moves = ""
    s._initial_fen = None
    s.lichess = mock.MagicMock()
    s.lichess.is_my_turn.return_value = True
    s.board_lock = threading.RLock()
    s.waiting_for_opponent = False
    return s


def test_sync_from_initial_fen():
    s = _bare_lichess_session()
    s._initial_fen = "4k3/8/8/8/8/8/4P3/4K3 w - - 0 1"
    s._sync_moves("e2e4")
    assert s.game.get_fen().split()[0] == "4k3/8/8/8/4P3/8/8/4K3"
    assert s.last_lichess_moves == "e2e4"


def test_bad_server_move_aborts_sync():
    s = _bare_lichess_session()
    s._sync_moves("e2e5")  # illegal from the start position
    assert s.last_lichess_moves == ""  # not marked synced: the next event retries


def test_finished_at_join_sets_stop():
    s = _bare_lichess_session()
    s.stop_event = threading.Event()
    s.my_color = None
    s.lichess.stream_game_with_reconnect.return_value = iter([{
        "type": "gameFull", "state": {"moves": "e2e4 e7e5", "status": "mate"}}])
    s.lichess.my_color = "white"
    s.game_id = "g"
    s._stream_task()
    assert s.stop_event.is_set()
    assert s.last_lichess_moves == "e2e4 e7e5"


SHUFFLE = "g1f3 g8f6 f3g1 f6g8"


def test_claimable_draw_is_claimed_once():
    s = _bare_lichess_session()
    s.auto_claim_draws = True
    s._sync_moves(f"{SHUFFLE} {SHUFFLE}")
    s.lichess.handle_draw_offer.assert_called_once_with(True)
    s._sync_moves(f"{SHUFFLE} {SHUFFLE}")  # the same list again: a no-op
    s.lichess.handle_draw_offer.assert_called_once()


def test_no_claim_when_not_claimable_disabled_or_terminal():
    s = _bare_lichess_session()
    s.auto_claim_draws = True
    s._sync_moves("e2e4 e7e5")
    s.lichess.handle_draw_offer.assert_not_called()
    s2 = _bare_lichess_session()  # default: disabled
    s2._sync_moves(f"{SHUFFLE} {SHUFFLE}")
    s2.lichess.handle_draw_offer.assert_not_called()
    s3 = _bare_lichess_session()  # the server already ended the game
    s3.auto_claim_draws = True
    s3._final_status = "outoftime"
    s3._sync_moves(f"{SHUFFLE} {SHUFFLE}")
    s3.lichess.handle_draw_offer.assert_not_called()


def test_claim_post_runs_outside_board_lock():
    s = _bare_lichess_session()
    s.auto_claim_draws = True
    lock_free = []

    def probe_lock(accept):
        # From another thread (the RLock is reentrant): can the lock be
        # taken while the POST is in flight?
        def probe():
            ok = s.board_lock.acquire(timeout=1)
            lock_free.append(ok)
            if ok:
                s.board_lock.release()

        t = threading.Thread(target=probe)
        t.start()
        t.join(timeout=5)
        assert not t.is_alive()

    s.lichess.handle_draw_offer.side_effect = probe_lock
    s._sync_moves(f"{SHUFFLE} {SHUFFLE}")
    s.lichess.handle_draw_offer.assert_called_once_with(True)
    assert lock_free == [True]


def _pgn_ready():
    s = _bare_lichess_session()
    s.player_color = "white"
    s.game_id = "abc123"
    s.clock_history = {}
    s.lichess.clock = None
    return s


def test_result_from_final_status():
    s = _pgn_ready()
    s._sync_moves("e2e4 e7e5")
    s._final_status, s._winner = "resign", "black"
    pgn = s.to_pgn()
    assert '[Result "0-1"]' in pgn and '[Termination "resign"]' in pgn
    s2 = _pgn_ready()
    s2._sync_moves("e2e4 e7e5")
    s2._final_status, s2._winner = "draw", None
    assert '[Result "1/2-1/2"]' in s2.to_pgn()
    s3 = _pgn_ready()  # still running: no adjudication
    s3._final_status = s3._winner = None
    s3._sync_moves("e2e4 e7e5")
    assert '[Result "*"]' in s3.to_pgn()


def test_terminal_gamestate_carries_final_move():
    s = _pgn_ready()
    s.stop_event = threading.Event()
    s.my_color = "white"
    s.auto_decline_draws = False
    s.draw_offered_by_opponent = False
    s.lichess.stream_game_with_reconnect.return_value = iter([
        {"type": "gameState", "status": "started", "moves": "f2f3 e7e5 g2g4"},
        {"type": "gameState", "status": "mate", "winner": "black",
         "moves": "f2f3 e7e5 g2g4 d8h4"},
    ])
    s._stream_task()
    assert s.game.board.is_checkmate() and s.stop_event.is_set()


@pytest.mark.parametrize("color,fen,moves,clocks,want", [
    ("white", None, ["e2e4", "e7e5"], {1: (292_000, 300_000), 2: (292_000, 287_000)},
     ["e4 {[%clk 0:04:52]}", "e5 {[%clk 0:04:47]}"]),
    # A from-position game with black to move: odd-numbered moves are black's.
    ("black", "rnbqkbnr/pppppppp/8/8/4P3/8/PPPP1PPP/RNBQKBNR b KQkq - 0 1",
     ["e7e5", "g1f3"], {1: (300_000, 292_000), 2: (287_000, 292_000)},
     ["e5 {[%clk 0:04:52]}", "Nf3 {[%clk 0:04:47]}"]),
], ids=["white_start", "black_start"])
def test_pgn_clock_annotations(color, fen, moves, clocks, want):
    """to_pgn's %clk comments: the mover's remaining time after each move."""
    s = LichessSession(client=mock.MagicMock(), device="cpu")
    s.configure({**CONFIG, "player_color": color})
    s.game_id = "abc12345"
    if fen:
        s._initial_fen = fen
        s.game.set_fen(fen)
    for uci in moves:
        s.game.board.push(Move.from_uci(uci))
    s.clock_history = clocks
    pgn = s.to_pgn()
    assert '[Site "https://lichess.org/abc12345"]' in pgn
    assert all(w in pgn for w in want), pgn


class _StreamClient:
    """A client whose stream replays a fixed event list, with the clock
    snapshot of each event as a LichessClient's stream sets it."""

    def __init__(self, events, clock_type):
        self.events, self.clock_type = events, clock_type
        self.my_color, self.clock, self.declined = "black", None, []

    def stream_game_with_reconnect(self, game_id, stop_check=None):
        for e in self.events:
            state = e.get("state", e)
            self.clock = self.clock_type(wtime_ms=state["wtime"], btime_ms=state["btime"])
            yield e

    def is_my_turn(self, moves):
        return (len(moves.split()) if moves else 0) % 2 == 1

    def get_last_move(self, moves):
        return moves.split()[-1] if moves else None

    def handle_draw_offer(self, accept):
        self.declined.append(accept)
        return True


def test_stream_through_both_packages_gives_the_same_board_and_pgn():
    """One game's events (gameFull, a draw offer, the terminal mate)
    through both packages' stream handlers: the same board, flags, clock
    HUD shape and PGN with %clk comments and the server's result."""
    events = [
        {"type": "gameFull", "state": {"moves": "", "status": "started",
                                       "wtime": 300_000, "btime": 300_000}},
        {"type": "gameState", "status": "started", "moves": "f2f3", "wtime": 299_000,
         "btime": 300_000, "wdraw": True},
        {"type": "gameState", "status": "started", "moves": "f2f3 e7e5 g2g4",
         "wtime": 297_000, "btime": 296_000},
        {"type": "gameState", "status": "mate", "winner": "black",
         "moves": "f2f3 e7e5 g2g4 d8h4", "wtime": 297_000, "btime": 290_000},
    ]
    out = []
    for cls, clock in ((JaxLichessSession, JaxClock), (LichessSession, ClockState)):
        kw = {"headless": True} if cls is JaxLichessSession else {"device": "cpu"}
        s = cls(client=_StreamClient(events, clock), **kw)
        s.configure({**CONFIG, "player_color": "black"})
        s.game_id = "g42"
        s._stream_task()
        out.append((s.game.get_fen(), s.stop_event.is_set(), s.lichess.declined,
                    s.draw_offered_by_opponent, s.my_color, s.to_pgn()))
    assert out[1] == out[0]
    fen, stopped, declined, offered, color, pgn = out[1]
    assert stopped and declined == [False] and not offered and color == "black"
    assert '[Result "0-1"]' in pgn and "{[%clk 0:04:50]}" in pgn
