"""Lichess Board API client (HTTP + NDJSON streaming).

The PyTorch port's own copy of chessboard_vision_tpu.net.lichess_client.
``requests`` is imported inside the methods that make HTTP calls, not at
import time: the card's machine has none, and a session with another
client (or a fake one) still imports this module there.

Behavioral equivalent of reference lichess_client.py: bearer-token auth
from .env, account check, ongoing-games list, NDJSON game-event stream
(long poll), move/resign POSTs, seek, turn parity from the move list.
Adds an optional reconnect loop around the stream (the reference's
generator simply ends on HTTP errors — SURVEY.md §2 elasticity note) and
the rest of the Board API surface the reference left out: clock state
from gameState events, draw offers, takebacks, abort, claim-victory, and
game chat.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Generator, Optional

from chessboard_vision_tpu_torch.utils.config import get_lichess_token
from chessboard_vision_tpu_torch.utils.logging import get_logger


@dataclass
class ClockState:
    """Clock snapshot from the latest gameState/gameFull event (ms).

    Board API times are in milliseconds; `at` is the host monotonic time
    when the snapshot was taken so remaining() can extrapolate the side
    to move without another round trip.
    """

    wtime_ms: int = 0
    btime_ms: int = 0
    winc_ms: int = 0
    binc_ms: int = 0
    at: float = 0.0

    @classmethod
    def from_event(cls, state: dict) -> "ClockState":
        return cls(
            wtime_ms=int(state.get("wtime", 0) or 0),
            btime_ms=int(state.get("btime", 0) or 0),
            winc_ms=int(state.get("winc", 0) or 0),
            binc_ms=int(state.get("binc", 0) or 0),
            at=time.monotonic(),
        )

    def remaining_ms(self, color: str, side_to_move: Optional[str] = None) -> int:
        """Remaining time for `color`, extrapolating the running clock.

        Only the side to move burns time; pass side_to_move (or None to
        return the raw snapshot value).
        """
        base = self.wtime_ms if color == "white" else self.btime_ms
        if side_to_move == color and self.at:
            base -= int((time.monotonic() - self.at) * 1000)
        return max(base, 0)


def _retry_after_seconds(resp, default: float = 60.0, cap: float = 120.0) -> float:
    """Seconds to wait from a 429's Retry-After header (lichess sends the
    seconds form; docs say 'wait a full minute' when absent)."""
    try:
        return min(float(resp.headers.get("Retry-After", default)), cap)
    except (TypeError, ValueError):
        return default


class LichessClient:
    BASE_URL = "https://lichess.org"

    def __init__(self, token: Optional[str] = None, env_path: str = ".env"):
        self.token = token if token is not None else get_lichess_token(env_path)
        self.username: Optional[str] = None
        self.current_game_id: Optional[str] = None
        self.my_color: Optional[str] = None
        self.clock: Optional[ClockState] = None
        self._headers = {}
        self.log = get_logger("lichess")

    def _rate_limit_wait(self, resp, what: str) -> float:
        """Log and sleep out a 429 (VERDICT r4 item 5: the reference
        client — lichess_client.py:147-177 — ignored rate limiting
        entirely; lichess throttles bursty clients and expects the
        Retry-After to be honored). Returns the seconds waited."""
        wait = _retry_after_seconds(resp)
        self.log.warning("%s rate-limited (429); waiting %.0f s", what, wait)
        time.sleep(wait)
        return wait

    def connect(self) -> bool:
        """Validate the token via GET /api/account."""
        import requests

        if not self.token:
            self.log.warning("LICHESS_TOKEN not found in .env")
            return False
        self._headers = {
            "Authorization": f"Bearer {self.token}",
            "Accept": "application/json",
        }
        try:
            for attempt in range(2):
                resp = requests.get(
                    f"{self.BASE_URL}/api/account", headers=self._headers, timeout=10
                )
                if resp.status_code == 200:
                    self.username = resp.json().get("username")
                    self.log.info("connected as %s", self.username)
                    return True
                if resp.status_code == 429 and attempt == 0:
                    self._rate_limit_wait(resp, "connect")
                    continue
                self.log.warning("account check failed: %s", resp.status_code)
                return False
            return False
        except requests.RequestException as e:
            self.log.warning("connection failed: %s", e)
            return False

    def get_ongoing_games(self) -> list:
        import requests

        try:
            resp = requests.get(
                f"{self.BASE_URL}/api/account/playing", headers=self._headers, timeout=10
            )
            if resp.status_code == 200:
                return resp.json().get("nowPlaying", [])
            return []
        except requests.RequestException as e:
            self.log.warning("get_ongoing_games failed: %s", e)
            return []

    def stream_game(self, game_id: str) -> Generator[dict, None, None]:
        """Yield NDJSON events from the long-lived game stream.

        Sets my_color when the gameFull event arrives. Returns (ends the
        generator) on stream errors, like the reference.
        """
        import requests

        self.current_game_id = game_id
        headers = {
            "Authorization": f"Bearer {self.token}",
            "Accept": "application/x-ndjson",
        }
        try:
            # (connect, read) timeout: lichess keep-alives arrive every few
            # seconds, so a 60 s read gap means the connection silently died
            # — raise and end the generator instead of blocking iter_lines()
            # forever (the reconnect wrapper then re-establishes the stream).
            resp = requests.get(
                f"{self.BASE_URL}/api/board/game/stream/{game_id}",
                headers=headers,
                stream=True,
                timeout=(10, 60),
            )
            if resp.status_code == 429:
                # Sleep out the Retry-After HERE so the reconnect
                # wrapper's short backoff does not hammer a throttled
                # endpoint (the stream runs on the daemon thread; blocking
                # it is the correct behavior while rate-limited).
                self._rate_limit_wait(resp, "stream")
                return
            if resp.status_code != 200:
                self.log.warning("stream error: %s", resp.status_code)
                return
            for line in resp.iter_lines():
                if not line:
                    continue
                try:
                    event = json.loads(line.decode("utf-8"))
                except json.JSONDecodeError:
                    continue
                etype = event.get("type")
                if etype == "gameFull":
                    self._set_my_color(event)
                    self.clock = ClockState.from_event(event.get("state", {}))
                elif etype == "gameState":
                    self.clock = ClockState.from_event(event)
                yield event
        except requests.RequestException as e:
            self.log.warning("stream error: %s", e)

    def stream_game_with_reconnect(
        self, game_id: str, stop_check=None, max_retries: int = 5, backoff: float = 2.0
    ) -> Generator[dict, None, None]:
        """stream_game wrapped in a bounded reconnect loop: up to
        max_retries consecutive dead attempts actually reconnect (any
        received event resets the budget), and there is no parting sleep
        once the budget is spent."""
        retries = 0
        while True:
            got_event = False
            for event in self.stream_game(game_id):
                got_event = True
                retries = 0
                yield event
                if stop_check and stop_check():
                    return
            if stop_check and stop_check():
                return
            if not got_event:
                retries += 1
            if retries > max_retries:
                self.log.info(
                    "stream dead after %d reconnects; giving up", max_retries
                )
                return
            self.log.info("stream ended; reconnect %d/%d", retries, max_retries)
            # Floor of one backoff even when the attempt was "productive"
            # (every connect yields gameFull, so retries==0 there — without
            # the floor a drop-after-handshake loop reconnects hot).
            time.sleep(backoff * max(retries, 1))

    def _set_my_color(self, event: dict):
        my_id = (self.username or "").lower()
        if event.get("white", {}).get("id", "").lower() == my_id:
            self.my_color = "white"
        elif event.get("black", {}).get("id", "").lower() == my_id:
            self.my_color = "black"
        self.log.info("playing as %s", self.my_color)

    def _move_landed(self, uci_move: str) -> bool:
        """Turn-state guard for the make_move retry: after a transient
        transport failure the POST may have SUCCEEDED with the response
        lost — re-POSTing would then be rejected 400 ('Not your turn') and
        the vision-confirmed move mis-reported as dropped. nowPlaying
        carries lastMove/isMyTurn, so one cheap GET disambiguates."""
        for g in self.get_ongoing_games():
            if g.get("gameId", g.get("id")) == self.current_game_id:
                return g.get("lastMove") == uci_move and not g.get("isMyTurn", False)
        return False

    def make_move(
        self, uci_move: str, offering_draw: bool = False, _retry: bool = True
    ) -> bool:
        """POST the move. Genuine rejections (4xx other than 429) still
        drop the move — the board is ahead of the server's reality and
        retrying cannot fix that — but a 429 honors Retry-After and
        re-POSTs once, and a transient transport exception retries once
        after the landed-move guard (VERDICT r4 item 5; the gap was
        inherited from reference lichess_client.py:147-177)."""
        import requests

        if not self.current_game_id:
            self.log.warning("no active game")
            return False
        try:
            resp = requests.post(
                f"{self.BASE_URL}/api/board/game/{self.current_game_id}/move/{uci_move}",
                headers=self._headers,
                params={"offeringDraw": "true"} if offering_draw else None,
                timeout=10,
            )
            if resp.status_code == 200:
                self.log.info("move sent: %s", uci_move)
                return True
            if resp.status_code == 429 and _retry:
                self._rate_limit_wait(resp, "make_move")
                return self.make_move(uci_move, offering_draw, _retry=False)
            self.log.warning("move rejected: %s %s", resp.status_code, resp.text)
            return False
        except requests.RequestException as e:
            self.log.warning("move error: %s", e)
            if _retry:
                if self._move_landed(uci_move):
                    self.log.info(
                        "move %s landed despite transport error", uci_move
                    )
                    return True
                self.log.info("retrying move %s once", uci_move)
                return self.make_move(uci_move, offering_draw, _retry=False)
            return False

    def _game_post(self, action: str) -> bool:
        """POST /api/board/game/{id}/{action} -> 200? (429 honors
        Retry-After and re-POSTs once; other failures return False)."""
        import requests

        if not self.current_game_id:
            return False
        try:
            for attempt in range(2):
                resp = requests.post(
                    f"{self.BASE_URL}/api/board/game/{self.current_game_id}/{action}",
                    headers=self._headers,
                    timeout=10,
                )
                if resp.status_code == 200:
                    return True
                if resp.status_code == 429 and attempt == 0:
                    self._rate_limit_wait(resp, action)
                    continue
                self.log.warning("%s failed: %s %s", action, resp.status_code, resp.text)
                return False
            return False
        except requests.RequestException as e:
            self.log.warning("%s error: %s", action, e)
            return False

    def abort(self) -> bool:
        """Abort the game (only legal before both sides have moved twice)."""
        return self._game_post("abort")

    def handle_draw_offer(self, accept: bool) -> bool:
        """Accept (or decline) an incoming draw offer — or offer one."""
        return self._game_post(f"draw/{'yes' if accept else 'no'}")

    def handle_takeback(self, accept: bool) -> bool:
        """Accept (or decline) an incoming takeback proposal."""
        return self._game_post(f"takeback/{'yes' if accept else 'no'}")

    def claim_victory(self) -> bool:
        """Claim the win after the opponent abandons the game."""
        return self._game_post("claim-victory")

    def send_chat(self, text: str, room: str = "player") -> bool:
        """Post to the game chat (room: 'player' or 'spectator')."""
        import requests

        if not self.current_game_id:
            return False
        try:
            resp = requests.post(
                f"{self.BASE_URL}/api/board/game/{self.current_game_id}/chat",
                headers=self._headers,
                data={"room": room, "text": text},
                timeout=10,
            )
            return resp.status_code == 200
        except requests.RequestException as e:
            self.log.warning("chat error: %s", e)
            return False

    def get_chat(self) -> list:
        """Fetch the game chat messages (list of {text, user} dicts)."""
        import requests

        if not self.current_game_id:
            return []
        try:
            resp = requests.get(
                f"{self.BASE_URL}/api/board/game/{self.current_game_id}/chat",
                headers=self._headers,
                timeout=10,
            )
            if resp.status_code == 200:
                return resp.json()
            return []
        except requests.RequestException as e:
            self.log.warning("get_chat error: %s", e)
            return []

    def resign(self) -> bool:
        import requests

        if not self.current_game_id:
            return False
        try:
            resp = requests.post(
                f"{self.BASE_URL}/api/board/game/{self.current_game_id}/resign",
                headers=self._headers,
                timeout=10,
            )
            return resp.status_code == 200
        except requests.RequestException:
            return False

    def is_my_turn(self, moves_str: str) -> bool:
        if not self.my_color:
            return False
        count = len(moves_str.split()) if moves_str else 0
        return count % 2 == (0 if self.my_color == "white" else 1)

    def get_last_move(self, moves_str: str) -> Optional[str]:
        moves = moves_str.split() if moves_str else []
        return moves[-1] if moves else None

    def seek_game(
        self,
        time_minutes: int = 10,
        increment: int = 0,
        rated: bool = False,
        poll_interval: float = 2.0,
        timeout_s: float = 120.0,
    ) -> Optional[str]:
        """Create a public seek and wait for it to be accepted.

        The Board API seek stream carries no data — it is keep-alive only,
        and the seek stays active exactly while the connection is open. So
        the match is detected by polling /api/account/playing for a game
        that wasn't there before; closing the stream afterwards is safe
        (a matched seek already created the game). Returns the new game id
        or None on timeout/error (closing then cancels the seek).
        """
        import requests

        before = {g.get("gameId", g.get("id")) for g in self.get_ongoing_games()}
        try:
            for attempt in range(2):
                resp = requests.post(
                    f"{self.BASE_URL}/api/board/seek",
                    headers={**self._headers, "Accept": "application/x-ndjson"},
                    # lila's form binder wants lowercase literals, not Python
                    # bool reprs ('True' would silently read as unrated)
                    data={
                        "time": time_minutes,
                        "increment": increment,
                        "rated": "true" if rated else "false",
                    },
                    stream=True,
                    timeout=(10, timeout_s),
                )
                if resp.status_code == 429 and attempt == 0:
                    self._rate_limit_wait(resp, "seek")
                    continue
                break
            if resp.status_code != 200:
                self.log.warning("seek rejected: %s %s", resp.status_code, resp.text)
                return None
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                time.sleep(poll_interval)
                for g in self.get_ongoing_games():
                    gid = g.get("gameId", g.get("id"))
                    if gid and gid not in before:
                        return gid
            self.log.info("seek timed out after %.0f s", timeout_s)
            return None
        except (requests.RequestException, json.JSONDecodeError) as e:
            self.log.warning("seek error: %s", e)
            return None
        finally:
            try:
                resp.close()
            except (NameError, AttributeError):
                pass
