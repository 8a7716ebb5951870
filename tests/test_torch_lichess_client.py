"""The port's LichessClient (net/lichess_client.py) with patched HTTP, no
network: every test of tests/test_lichess_client.py run against the port.
The port imports ``requests`` inside the client's methods (the card's
machine has none), so the tests patch ``requests.get``/``requests.post``
on the requests module, where that import finds them: turn parity, last
move, connect success/failure, move accepted/rejected/no-game, 429 and
transient-error retries, NDJSON stream parsing, the reconnect wrapper,
seek, the Board API extras, the clock, and LichessSession's draw flags and
clock HUD."""

import json
from unittest import mock

from chessboard_vision_tpu_torch.net.lichess_client import LichessClient


def make_client():
    c = LichessClient(token="test-token")
    return c


class TestTurnParity:
    def test_white_turn(self):
        c = make_client()
        c.my_color = "white"
        assert c.is_my_turn("")
        assert not c.is_my_turn("e2e4")
        assert c.is_my_turn("e2e4 e7e5")

    def test_black_turn(self):
        c = make_client()
        c.my_color = "black"
        assert not c.is_my_turn("")
        assert c.is_my_turn("e2e4")

    def test_no_color(self):
        c = make_client()
        assert not c.is_my_turn("e2e4")

    def test_last_move(self):
        c = make_client()
        assert c.get_last_move("e2e4 e7e5") == "e7e5"
        assert c.get_last_move("") is None


class TestConnect:
    @mock.patch("requests.get")
    def test_connect_success(self, get):
        resp = mock.MagicMock(status_code=200)
        resp.json.return_value = {"username": "tester"}
        get.return_value = resp
        c = make_client()
        assert c.connect()
        assert c.username == "tester"

    @mock.patch("requests.get")
    def test_connect_401(self, get):
        get.return_value = mock.MagicMock(status_code=401)
        c = make_client()
        assert not c.connect()

    def test_connect_without_token(self):
        c = LichessClient(token="")
        assert not c.connect()


class TestMoves:
    @mock.patch("requests.post")
    def test_move_accepted(self, post):
        post.return_value = mock.MagicMock(status_code=200)
        c = make_client()
        c.current_game_id = "abc"
        assert c.make_move("e2e4")
        assert "abc" in post.call_args[0][0] and "e2e4" in post.call_args[0][0]

    @mock.patch("requests.post")
    def test_move_rejected(self, post):
        post.return_value = mock.MagicMock(status_code=400, text="invalid")
        c = make_client()
        c.current_game_id = "abc"
        assert not c.make_move("e2e5")

    def test_move_without_game(self):
        c = make_client()
        assert not c.make_move("e2e4")


class TestRateLimitAndRetry:
    """429/Retry-After handling + bounded transient-exception retry
    (VERDICT r4 item 5 — the reference client, lichess_client.py:147-177,
    dropped the move on ANY non-200 and ignored rate limiting)."""

    @mock.patch("chessboard_vision_tpu_torch.net.lichess_client.time.sleep")
    @mock.patch("requests.post")
    def test_move_429_waits_retry_after_then_succeeds(self, post, sleep):
        post.side_effect = [
            mock.MagicMock(status_code=429, text="", headers={"Retry-After": "3"}),
            mock.MagicMock(status_code=200),
        ]
        c = make_client()
        c.current_game_id = "abc"
        assert c.make_move("e2e4")
        assert post.call_count == 2
        sleep.assert_called_once_with(3.0)

    @mock.patch("chessboard_vision_tpu_torch.net.lichess_client.time.sleep")
    @mock.patch("requests.post")
    def test_move_429_missing_header_waits_a_minute(self, post, sleep):
        """Lichess docs: 'wait a full minute' when throttled — that is the
        default when no Retry-After header arrives."""
        post.side_effect = [
            mock.MagicMock(status_code=429, text="", headers={}),
            mock.MagicMock(status_code=200),
        ]
        c = make_client()
        c.current_game_id = "abc"
        assert c.make_move("e2e4")
        sleep.assert_called_once_with(60.0)

    @mock.patch("chessboard_vision_tpu_torch.net.lichess_client.time.sleep")
    @mock.patch("requests.post")
    def test_move_429_twice_drops(self, post, sleep):
        post.return_value = mock.MagicMock(
            status_code=429, text="", headers={"Retry-After": "1"}
        )
        c = make_client()
        c.current_game_id = "abc"
        assert not c.make_move("e2e4")
        assert post.call_count == 2  # bounded: one retry only

    @mock.patch("requests.post")
    def test_move_genuine_rejection_not_retried(self, post):
        """4xx other than 429 is a real rejection — retrying cannot fix a
        board that is ahead of the server; the drop semantics stay."""
        post.return_value = mock.MagicMock(status_code=400, text="Not your turn")
        c = make_client()
        c.current_game_id = "abc"
        assert not c.make_move("e2e4")
        assert post.call_count == 1

    @mock.patch("requests.get")
    @mock.patch("requests.post")
    def test_move_transient_exception_retries_once(self, post, get):
        import requests as _rq

        post.side_effect = [
            _rq.ConnectionError("reset"),
            mock.MagicMock(status_code=200),
        ]
        # landed-move guard: game state shows the move did NOT land
        get.return_value = mock.MagicMock(
            status_code=200,
            json=lambda: {"nowPlaying": [
                {"gameId": "abc", "lastMove": "d7d5", "isMyTurn": True}
            ]},
        )
        c = make_client()
        c.current_game_id = "abc"
        assert c.make_move("e2e4")
        assert post.call_count == 2

    @mock.patch("requests.get")
    @mock.patch("requests.post")
    def test_move_landed_despite_lost_response_is_not_reposted(self, post, get):
        """The POST succeeded but the response was lost: the turn-state
        guard sees lastMove == our move and does NOT re-POST (a re-POST
        would 400 and mis-report a landed move as dropped)."""
        import requests as _rq

        post.side_effect = _rq.ConnectionError("response lost")
        get.return_value = mock.MagicMock(
            status_code=200,
            json=lambda: {"nowPlaying": [
                {"gameId": "abc", "lastMove": "e2e4", "isMyTurn": False}
            ]},
        )
        c = make_client()
        c.current_game_id = "abc"
        assert c.make_move("e2e4")
        assert post.call_count == 1

    @mock.patch("requests.get")
    @mock.patch("requests.post")
    def test_move_exception_twice_drops(self, post, get):
        import requests as _rq

        post.side_effect = _rq.ConnectionError("reset")
        get.return_value = mock.MagicMock(
            status_code=200, json=lambda: {"nowPlaying": []}
        )
        c = make_client()
        c.current_game_id = "abc"
        assert not c.make_move("e2e4")
        assert post.call_count == 2  # bounded

    @mock.patch("chessboard_vision_tpu_torch.net.lichess_client.time.sleep")
    @mock.patch("requests.get")
    def test_stream_429_sleeps_retry_after_then_ends(self, get, sleep):
        get.return_value = mock.MagicMock(
            status_code=429, headers={"Retry-After": "45"}
        )
        c = make_client()
        assert list(c.stream_game("gid")) == []
        sleep.assert_called_once_with(45.0)

    @mock.patch("chessboard_vision_tpu_torch.net.lichess_client.time.sleep")
    @mock.patch("requests.get")
    def test_connect_429_waits_then_succeeds(self, get, sleep):
        ok = mock.MagicMock(status_code=200)
        ok.json.return_value = {"username": "tester"}
        get.side_effect = [
            mock.MagicMock(status_code=429, headers={"Retry-After": "2"}),
            ok,
        ]
        c = make_client()
        assert c.connect()
        sleep.assert_called_once_with(2.0)

    @mock.patch("chessboard_vision_tpu_torch.net.lichess_client.time.sleep")
    @mock.patch("requests.post")
    def test_game_post_429_waits_then_succeeds(self, post, sleep):
        post.side_effect = [
            mock.MagicMock(status_code=429, text="", headers={"Retry-After": "5"}),
            mock.MagicMock(status_code=200),
        ]
        c = make_client()
        c.current_game_id = "abc"
        assert c.handle_draw_offer(True)
        sleep.assert_called_once_with(5.0)

    def test_retry_after_parse(self):
        from chessboard_vision_tpu_torch.net.lichess_client import _retry_after_seconds

        assert _retry_after_seconds(
            mock.MagicMock(headers={"Retry-After": "30"})
        ) == 30.0
        assert _retry_after_seconds(mock.MagicMock(headers={})) == 60.0
        # non-numeric (HTTP-date form) falls back to the default
        assert _retry_after_seconds(
            mock.MagicMock(headers={"Retry-After": "Wed, 19 Aug 2026 16:00:00 GMT"})
        ) == 60.0
        # capped so a hostile header cannot park the client for hours
        assert _retry_after_seconds(
            mock.MagicMock(headers={"Retry-After": "86400"})
        ) == 120.0


class TestStream:
    @mock.patch("requests.get")
    def test_stream_parses_ndjson_and_sets_color(self, get):
        events = [
            {"type": "gameFull", "white": {"id": "tester"}, "black": {"id": "opp"},
             "state": {"moves": ""}},
            {"type": "gameState", "moves": "e2e4", "status": "started"},
        ]
        resp = mock.MagicMock(status_code=200)
        resp.iter_lines.return_value = [json.dumps(e).encode() for e in events] + [b""]
        get.return_value = resp
        c = make_client()
        c.username = "tester"
        got = list(c.stream_game("gid"))
        assert [e["type"] for e in got] == ["gameFull", "gameState"]
        assert c.my_color == "white"

    @mock.patch("requests.get")
    def test_stream_error_status_ends(self, get):
        get.return_value = mock.MagicMock(status_code=404)
        c = make_client()
        assert list(c.stream_game("gid")) == []

    @mock.patch("requests.get")
    def test_stream_skips_bad_json(self, get):
        resp = mock.MagicMock(status_code=200)
        resp.iter_lines.return_value = [b"not-json", json.dumps({"type": "gameState"}).encode()]
        get.return_value = resp
        c = make_client()
        got = list(c.stream_game("gid"))
        assert len(got) == 1

    @mock.patch("chessboard_vision_tpu_torch.net.lichess_client.time.sleep")
    @mock.patch("requests.get")
    def test_reconnect_wrapper_stops_on_stop_check(self, get, _sleep):
        resp = mock.MagicMock(status_code=200)
        resp.iter_lines.return_value = [json.dumps({"type": "gameState"}).encode()]
        get.return_value = resp
        c = make_client()
        stop = {"flag": False}

        def stop_check():
            stop["flag"] = True
            return stop["flag"]

        got = list(c.stream_game_with_reconnect("gid", stop_check=stop_check))
        assert len(got) == 1


class TestSeek:
    @mock.patch("chessboard_vision_tpu_torch.net.lichess_client.time.sleep")
    @mock.patch("requests.post")
    @mock.patch("requests.get")
    def test_seek_matches_via_ongoing_games_poll(self, get, post, _sleep):
        """The Board API seek stream is keep-alive only; the match is
        detected by polling /api/account/playing for a NEW game id
        (see test_session_fixes.TestSeek for rated-flag encoding)."""
        post.return_value = mock.MagicMock(status_code=200)
        lists = [[{"gameId": "old"}], [{"gameId": "old"}, {"gameId": "g123"}]]
        get.side_effect = [
            mock.MagicMock(status_code=200, json=lambda g=g: {"nowPlaying": g})
            for g in lists
        ]
        c = make_client()
        assert c.seek_game() == "g123"

    @mock.patch("chessboard_vision_tpu_torch.net.lichess_client.time.sleep")
    @mock.patch("requests.post")
    @mock.patch("requests.get")
    def test_seek_rejected_returns_none(self, get, post, sleep):
        """A persistently rate-limited seek waits Retry-After once, then
        gives up (still rejected on the retry)."""
        get.return_value = mock.MagicMock(
            status_code=200, json=lambda: {"nowPlaying": []}
        )
        post.return_value = mock.MagicMock(
            status_code=429, text="rate limited", headers={"Retry-After": "60"}
        )
        c = make_client()
        assert c.seek_game() is None
        assert post.call_count == 2
        sleep.assert_called_once_with(60.0)


class TestBoardApiExtras:
    """Draw offers, takeback, abort, claim-victory, chat, offeringDraw."""

    @mock.patch("requests.post")
    def test_move_with_draw_offer(self, post):
        post.return_value = mock.MagicMock(status_code=200)
        c = make_client()
        c.current_game_id = "abc"
        assert c.make_move("e2e4", offering_draw=True)
        assert post.call_args.kwargs["params"] == {"offeringDraw": "true"}
        assert c.make_move("e7e5")
        assert post.call_args.kwargs["params"] is None

    @mock.patch("requests.post")
    def test_draw_takeback_abort_claim(self, post):
        post.return_value = mock.MagicMock(status_code=200)
        c = make_client()
        c.current_game_id = "abc"
        assert c.handle_draw_offer(True)
        assert post.call_args[0][0].endswith("/abc/draw/yes")
        assert c.handle_draw_offer(False)
        assert post.call_args[0][0].endswith("/abc/draw/no")
        assert c.handle_takeback(True)
        assert post.call_args[0][0].endswith("/abc/takeback/yes")
        assert c.abort()
        assert post.call_args[0][0].endswith("/abc/abort")
        assert c.claim_victory()
        assert post.call_args[0][0].endswith("/abc/claim-victory")

    def test_extras_without_game_are_false(self):
        c = make_client()
        assert not c.abort()
        assert not c.handle_draw_offer(True)
        assert not c.send_chat("hi")
        assert c.get_chat() == []

    @mock.patch("requests.post")
    def test_send_chat(self, post):
        post.return_value = mock.MagicMock(status_code=200)
        c = make_client()
        c.current_game_id = "abc"
        assert c.send_chat("good game", room="spectator")
        assert post.call_args.kwargs["data"] == {"room": "spectator", "text": "good game"}

    @mock.patch("requests.get")
    def test_get_chat(self, get):
        resp = mock.MagicMock(status_code=200)
        resp.json.return_value = [{"text": "glhf", "user": "opp"}]
        get.return_value = resp
        c = make_client()
        c.current_game_id = "abc"
        assert c.get_chat() == [{"text": "glhf", "user": "opp"}]


class TestClock:
    @mock.patch("requests.get")
    def test_stream_updates_clock(self, get):
        events = [
            {"type": "gameFull", "white": {"id": "tester"}, "black": {"id": "opp"},
             "state": {"moves": "", "wtime": 600000, "btime": 600000,
                       "winc": 5000, "binc": 5000}},
            {"type": "gameState", "moves": "e2e4", "status": "started",
             "wtime": 595000, "btime": 600000, "winc": 5000, "binc": 5000},
        ]
        resp = mock.MagicMock(status_code=200)
        resp.iter_lines.return_value = [json.dumps(e).encode() for e in events]
        get.return_value = resp
        c = make_client()
        c.username = "tester"
        list(c.stream_game("gid"))
        assert c.clock is not None
        assert c.clock.wtime_ms == 595000
        assert c.clock.winc_ms == 5000

    def test_remaining_extrapolates_side_to_move(self):
        from chessboard_vision_tpu_torch.net.lichess_client import ClockState
        import time as _time

        clk = ClockState(wtime_ms=60000, btime_ms=60000, at=_time.monotonic() - 2.0)
        # side to move burns ~2 s; the waiting side does not
        assert clk.remaining_ms("white", "white") <= 58100
        assert clk.remaining_ms("black", "white") == 60000
        # raw snapshot when side_to_move is unknown
        assert clk.remaining_ms("white", None) == 60000
        # never negative
        clk2 = ClockState(wtime_ms=500, at=_time.monotonic() - 5.0)
        assert clk2.remaining_ms("white", "white") == 0


class TestSessionDrawHandling:
    def test_auto_decline_draw_offer(self):
        from chessboard_vision_tpu_torch.session.lichess_session import LichessSession

        client = mock.MagicMock()
        s = LichessSession.__new__(LichessSession)
        s.lichess = client
        s.my_color = "white"
        s.draw_offered_by_opponent = False
        s.auto_decline_draws = True
        import logging

        s.log = logging.getLogger("test")
        s._handle_draw_flags({"bdraw": True})
        client.handle_draw_offer.assert_called_once_with(False)
        assert not s.draw_offered_by_opponent

    def test_surfaced_draw_offer_when_not_auto(self):
        from chessboard_vision_tpu_torch.session.lichess_session import LichessSession

        client = mock.MagicMock()
        s = LichessSession.__new__(LichessSession)
        s.lichess = client
        s.my_color = "black"
        s.draw_offered_by_opponent = False
        s.auto_decline_draws = False
        import logging

        s.log = logging.getLogger("test")
        s._handle_draw_flags({"wdraw": True})
        client.handle_draw_offer.assert_not_called()
        assert s.draw_offered_by_opponent

    def test_clock_hud_format(self):
        from chessboard_vision_tpu_torch.session.lichess_session import LichessSession
        from chessboard_vision_tpu_torch.net.lichess_client import ClockState

        client = mock.MagicMock()
        client.clock = ClockState(wtime_ms=272000, btime_ms=301000, at=0.0)
        s = LichessSession.__new__(LichessSession)
        s.lichess = client
        s.last_lichess_moves = "e2e4"
        hud = s.clock_hud()
        assert hud == "W 4:32 | B 5:01"
        client.clock = None
        assert s.clock_hud() == ""
