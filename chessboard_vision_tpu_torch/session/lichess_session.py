"""LichessSession: GameSession wired to the Lichess Board API.

The PyTorch port's counterpart of chessboard_vision_tpu.session.
lichess_session: the vision step runs on the session's device (keywords
of the port's GameSession, ``device`` among them), the rest is the JAX
module's host logic. Behavioral equivalent of reference
lichess_session.py: overrides
on_move_detected to POST detected moves; a background daemon thread
replays the server's move list into the local board under board_lock with
double-checked locking (the reference's consistency protocol, SURVEY.md
§3.3); CLI helpers to select or await a game.
"""

from __future__ import annotations

import threading
import time

from chessboard_vision_tpu_torch.net.lichess_client import LichessClient
from chessboard_vision_tpu_torch.session.game_session import GameSession


class LichessSession(GameSession):
    def __init__(self, client: LichessClient = None, **kw):
        """``client``: the Board API client (a LichessClient reading the
        token from .env when None); ``kw`` go to GameSession."""
        super().__init__(**kw)
        self.lichess = client if client is not None else LichessClient()
        self.game_id = None
        self.my_color = None
        self.waiting_for_opponent = False
        self.last_lichess_moves = ""
        self.stop_event = threading.Event()
        self._stream_thread = None
        # Board API extras: auto-decline opponent draw offers unless the
        # host app opts in; surface the clock for the HUD.
        self.auto_decline_draws = True
        self.draw_offered_by_opponent = False
        # Opt-in: when the rules engine says the position is claimable
        # (50-move / threefold — rules/chesslib.can_claim_draw) on OUR
        # turn, send the draw offer/claim (lichess grants a claimable
        # draw immediately). Off by default: claiming is a strategy
        # decision, not a vision one.
        self.auto_claim_draws = False
        self._draw_claimed_at = None  # move count of the last claim sent
        self._initial_fen = None  # gameFull initialFen for from-position games
        # Terminal status/winner from the stream ("mate", "resign",
        # "outoftime", "draw", ... + "white"/"black"): to_pgn derives the
        # Result tag from the SERVER's adjudication, never from the final
        # position alone (a claimable position proves nothing about how
        # the game actually ended).
        self._final_status = None
        self._winner = None
        # {move_count: (wtime_ms, btime_ms)} snapshots recorded at each
        # server sync — feeds to_pgn's standard %clk annotations.
        self.clock_history = {}

    def connect_and_setup(self, interactive: bool = True) -> bool:
        self.log.info("connecting to Lichess...")
        if not self.lichess.connect():
            self.log.warning("Lichess connection failed")
            return False
        game_id = self._select_or_create_game() if interactive else self._first_ongoing_game()
        if not game_id:
            return False
        self.start_game(game_id)
        return True

    def start_game(self, game_id: str):
        """Attach to a game id and start the background stream thread."""
        self.game_id = game_id
        self.log.info("joining game %s", game_id)
        self._stream_thread = threading.Thread(target=self._stream_task, daemon=True)
        self._stream_thread.start()
        time.sleep(0.5)  # allow initial sync

    def on_move_detected(self, move) -> bool:
        """Send the detected move to Lichess; reject when not our turn."""
        if self.waiting_for_opponent:
            self.log.info("not our turn; move %s ignored", move.uci())
            return False
        uci = move.uci()
        if self.lichess.make_move(uci):
            self.waiting_for_opponent = True
            # Lock already held by the caller (GameSession commit path).
            self.last_lichess_moves = (
                f"{self.last_lichess_moves} {uci}".strip()
            )
            return True
        self.log.warning("move %s rejected by API", uci)
        return False

    def _stream_task(self):
        # Reconnecting stream: a silently dropped connection raises a read
        # timeout inside stream_game (timeout=(10, 60)), and the wrapper
        # re-establishes the long poll — a mid-game network blip must not
        # permanently stop opponent-move syncing.
        events = self.lichess.stream_game_with_reconnect(
            self.game_id, stop_check=self.stop_event.is_set
        )
        for event in events:
            if self.stop_event.is_set():
                break
            etype = event.get("type")
            if etype == "gameFull":
                self.my_color = self.lichess.my_color
                # Games created "From Position" replay from their own
                # start FEN, not the standard one.
                fen0 = event.get("initialFen")
                if fen0 and fen0 != "startpos":
                    self._initial_fen = fen0
                state = event.get("state", {})
                status = state.get("status")
                if status and status != "started":
                    # Joined an already-finished game: no further
                    # gameState will arrive to end the session.
                    self.log.info("game already finished: %s", status)
                    self._final_status = status
                    self._winner = state.get("winner")
                    self._sync_moves(state.get("moves", ""))
                    self.stop_event.set()
                    continue
                self._sync_moves(state.get("moves", ""))
            elif etype == "gameState":
                status = event.get("status")
                if status != "started":
                    self.log.info("game finished: %s", status)
                    self._final_status = status
                    self._winner = event.get("winner")
                    # The terminal event CARRIES the final move (e.g. the
                    # mate) — sync it so the local board/PGN are complete.
                    self._sync_moves(event.get("moves", ""))
                    self.stop_event.set()
                else:
                    self._handle_draw_flags(event)
                    self._sync_moves(event.get("moves", ""))

    def _handle_draw_flags(self, event: dict):
        """wdraw/bdraw mark a pending draw offer from that side."""
        if self.my_color is None:
            # Reconnect edge: a gameState before any gameFull — defer
            # rather than guess (guessing 'wdraw' could auto-decline our
            # own pending offer when we are white).
            return
        opp_flag = "bdraw" if self.my_color == "white" else "wdraw"
        offered = bool(event.get(opp_flag))
        if offered and not self.draw_offered_by_opponent:
            self.log.info("opponent offered a draw")
            if self.auto_decline_draws:
                self.lichess.handle_draw_offer(False)
                offered = False
        self.draw_offered_by_opponent = offered

    def clock_hud(self) -> str:
        """'W 4:32 | B 5:01' from the latest clock snapshot ('' if none)."""
        clk = self.lichess.clock
        if clk is None:
            return ""
        stm = None
        if self.last_lichess_moves is not None:
            n = len(self.last_lichess_moves.split()) if self.last_lichess_moves else 0
            stm = "white" if n % 2 == 0 else "black"

        def fmt(ms):
            s = ms // 1000
            return f"{s // 60}:{s % 60:02d}"

        return (
            f"W {fmt(clk.remaining_ms('white', stm))} | "
            f"B {fmt(clk.remaining_ms('black', stm))}"
        )

    def _sync_moves(self, moves_str: str):
        """Replay the authoritative server move list (double-checked lock).

        Replays from the game's initial FEN (set by gameFull for
        from-position games). A move that fails to apply is a real
        desync — logged loudly and the sync is NOT marked complete, so
        the next event retries instead of silently playing on a wrong
        board."""
        if moves_str == self.last_lichess_moves:
            return
        claim_kind = None  # set under the lock, POSTed after it (below)
        with self.board_lock:
            if moves_str == self.last_lichess_moves:
                return
            initial = getattr(self, "_initial_fen", None)
            if initial:
                self.game.set_fen(initial)
            else:
                self.game.reset()
            if moves_str:
                for uci in moves_str.split():
                    try:
                        self.game.board.push_uci(uci)
                    except ValueError:
                        self.log.error(
                            "CRITICAL: server move %r does not apply to the "
                            "local board (%s) — sync aborted, will retry",
                            uci, self.game.get_fen(),
                        )
                        return
            self.last_lichess_moves = moves_str
            clk = getattr(self.lichess, "clock", None)  # mocks/minimal clients
            if clk is not None:
                n_moves = len(moves_str.split()) if moves_str else 0
                # setdefault: some isolation tests drive _sync_moves on a
                # partially-constructed session (object.__new__ pattern)
                self.__dict__.setdefault("clock_history", {})[n_moves] = (
                    clk.wtime_ms, clk.btime_ms,
                )
            is_my_turn = self.lichess.is_my_turn(moves_str)
            self.waiting_for_opponent = not is_my_turn
            if not is_my_turn:
                last = self.lichess.get_last_move(moves_str)
                if last:
                    self.log.info("opponent played: %s", last)
            elif (
                getattr(self, "auto_claim_draws", False)
                and getattr(self, "_final_status", None) is None
            ):
                n_moves = len(moves_str.split()) if moves_str else 0
                if (
                    getattr(self, "_draw_claimed_at", None) != n_moves
                    and self.game.board.can_claim_draw()
                ):
                    self._draw_claimed_at = n_moves  # once per position
                    claim_kind = (
                        "50-move" if self.game.board.can_claim_fifty_moves()
                        else "threefold"
                    )
        if claim_kind is not None:
            # OUTSIDE board_lock: the claim is a blocking HTTP POST (up to
            # the client's 10 s timeout) — holding the lock here would
            # stall the vision thread's per-frame inference for the
            # duration (same discipline as _handle_draw_flags' decline).
            self.log.info(
                "position is a claimable draw (%s) — claiming", claim_kind
            )
            self.lichess.handle_draw_offer(True)

    def to_pgn(self, headers=None, comments=None) -> str:
        """PGN with standard {[%clk H:MM:SS]} annotations from the stream's
        clock snapshots (the mover's remaining time after each move —
        lichess's own export form). Only moves whose gameState event was
        observed carry a clock."""
        clk_comments = {}
        # Mover parity hangs off the START position's side to move: in a
        # from-position game that begins with black to move, the odd-
        # numbered moves are BLACK's (ADVICE r3).
        start_white = True
        if self.game is not None:
            start_white = self.game.start_fen.split()[1] == "w"
        elif self._initial_fen:
            start_white = self._initial_fen.split()[1] == "w"
        for n, (wtime, btime) in self.clock_history.items():
            if n < 1:
                continue
            white_moved = (n % 2 == 1) == start_white
            ms = wtime if white_moved else btime
            s_total = ms // 1000
            clk_comments[n - 1] = (
                f"[%clk {s_total // 3600}:{(s_total // 60) % 60:02d}:{s_total % 60:02d}]"
            )
        if comments:
            clk_comments.update(comments)
        tags = {"Site": "https://lichess.org", "Event": "Lichess game"}
        if self.game_id:
            tags["Site"] = f"https://lichess.org/{self.game_id}"
        # Result from the SERVER's adjudication (time losses, resignations
        # and agreed/claimed draws are invisible in the move list; deriving
        # them from the final position would be wrong).
        result = None
        status = getattr(self, "_final_status", None)
        if status and status not in ("aborted", "noStart", "unknownFinish"):
            winner = getattr(self, "_winner", None)
            if winner == "white":
                result = "1-0"
            elif winner == "black":
                result = "0-1"
            else:
                result = "1/2-1/2"
            tags["Termination"] = status
        if headers:
            tags.update(headers)  # caller overrides, incl. Termination/Result
        return super().to_pgn(
            headers=tags, comments=clk_comments or None, result=result
        )

    def on_exit(self):
        self.stop_event.set()

    # -- CLI helpers ------------------------------------------------------

    def _first_ongoing_game(self):
        games = self.lichess.get_ongoing_games()
        if games:
            return games[0].get("gameId", games[0].get("id"))
        return None

    def _select_or_create_game(self):
        games = self.lichess.get_ongoing_games()
        if games:
            print("\n=== ONGOING GAMES ===")
            for i, g in enumerate(games):
                gid = g.get("gameId", g.get("id"))
                opp = g.get("opponent", {}).get("username", "?")
                print(f"  [{i + 1}] {gid}: vs {opp}")
            print("\n  [0] Wait for a new game")
            try:
                choice = input("Choice: ")
                if choice == "0":
                    return self._wait_for_challenge()
                idx = int(choice) - 1
                if 0 <= idx < len(games):
                    return games[idx].get("gameId", games[idx].get("id"))
            except (ValueError, EOFError):
                pass
        return self._wait_for_challenge()

    def _wait_for_challenge(self):
        print("\n=== WAITING FOR GAME ===\nCreate a game on Lichess now...")
        try:
            while not self.stop_event.is_set():
                time.sleep(2)
                games = self.lichess.get_ongoing_games()
                if games:
                    return games[0].get("gameId", games[0].get("id"))
                print(".", end="", flush=True)
        except KeyboardInterrupt:
            return None
