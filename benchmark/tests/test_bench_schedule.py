"""The traffic generator: seeded quiet legal games, spaced as the mix says."""

import json
import os

import pytest

from benchmark.reference import chesslib as chess
from benchmark.schedule import BoardScript, Traffic, quiet_game
from benchmark.tests.tiny import ROOT, SEED


def mix(name, seconds=30.0):
    with open(os.path.join(ROOT, "benchmark", "traffic", name + ".json")) as fh:
        return Traffic.from_json(json.load(fh), seconds)


@pytest.mark.parametrize("seed,board", [(SEED, 0), (SEED, 7), (0, 3), (2**40 + 9, 1)])
def test_quiet_games_are_legal_and_seeded(seed, board):
    moves = quiet_game(seed, board, 12)
    assert len(moves) == 12
    assert [m.uci() for m in moves] == [m.uci() for m in quiet_game(seed, board, 12)]
    b = chess.Board()
    for m in moves:
        assert m in b.legal_moves and m.promotion is None
        assert b.piece_at(m.to_square) is None and not b.is_castling(m)
        assert not b.is_en_passant(m)
        b.push(m)


def test_boards_play_different_games():
    games = {tuple(m.uci() for m in quiet_game(SEED, b, 8)) for b in range(8)}
    assert len(games) == 8


def test_player_mix_spacing():
    t = mix("live30")
    assert t.loop == "open" and t.rate_hz == 30 and t.max_moves == 8
    s = BoardScript(t, SEED, 0)
    first = t.warmup_calls + t.first_move_after
    assert [s.state(c) for c in range(first)] == [0] * first
    for k in range(len(s.moves)):
        start = first + k * t.move_every
        assert {s.state(c) for c in range(start, start + t.hand_calls)} == {len(s.moves) + k + 1}
        assert {s.state(c) for c in range(start + t.hand_calls, start + t.move_every)} == {k + 1}
    assert s.commits_due(10**6) == len(s.moves)


def test_hall_mix_stagger_and_cap():
    t = mix("capacity")
    assert t.loop == "closed" and t.max_moves == 8
    scripts = [BoardScript(t, SEED, b) for b in range(8)]
    starts = [s.start for s in scripts]
    assert [b - a for a, b in zip(starts, starts[1:])] == [t.stagger] * 7
    assert all(s.n_scenes == 17 for s in scripts)
    assert scripts[0].state(10**6) == 8  # holds still after its 8 moves


def test_scene_of_a_hand_is_the_position_after_the_move():
    t = mix("live30")
    s = BoardScript(t, SEED, 0)
    board, hand = s.scene(len(s.moves) + 1)
    m = s.moves[0]
    assert board.fen() == s.boards[1].fen()
    assert hand == ((chess.square_file(m.from_square), chess.square_rank(m.from_square)),
                    (chess.square_file(m.to_square), chess.square_rank(m.to_square)))
