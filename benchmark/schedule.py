"""The general traffic generator: a traffic mix's parameters -> each board's
seeded game and the scene that every session call shows.

A mix (``traffic/<mix>.json``) gives:

- ``loop``: "open" (frames due at ``rate_hz``, handed over when due or at
  once when the loop is behind) or "closed" (a call as soon as the last one
  returned);
- ``warmup_calls``: calls on the initial position during set-up;
- ``first_move_after``: timed calls before the first board's first move;
- ``move_every``: calls between one board's moves; ``stagger``: calls
  between board b's schedule and board b + 1's;
- ``hand_calls``: calls a move shows the hand over its from- and to-squares
  before the new position;
- ``max_moves``: moves a board makes before it holds still (null: as many
  as the calls of a run reach);
- ``renders``: seeded renders of each scene, cycled call by call;
- ``trace_calls``: calls of each traced stretch (``--trace 1``).

Calls are counted from the first warm-up call, so call c of board b shows
scene ``state(b, c)`` in render ``c % renders``. A board's moves are quiet
legal moves (no capture, castling, en passant or promotion: each changes
exactly two squares), drawn from the seed with the board's index.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from .reference import chesslib as chess

TRACE_STRETCHES = 2  # a traced run's stretches: one plain, one with Python stacks


class Traffic(NamedTuple):
    loop: str
    rate_hz: float
    warmup_calls: int
    first_move_after: int
    move_every: int
    stagger: int
    hand_calls: int
    max_moves: int
    renders: int
    trace_calls: int

    @classmethod
    def from_json(cls, d: dict, seconds: float) -> "Traffic":
        """The mix, with ``max_moves`` bounded by the calls an open loop of
        ``seconds`` makes (a closed loop's mix has to state it)."""
        if d["loop"] not in ("open", "closed"):
            raise ValueError(f"loop {d['loop']!r}: 'open' or 'closed'")
        max_moves = d.get("max_moves")
        if max_moves is None:
            if d["loop"] != "open":
                raise ValueError("a closed loop's mix states max_moves")
            horizon = (d["warmup_calls"] + int(round(d["rate_hz"] * seconds))
                       + TRACE_STRETCHES * d["trace_calls"])
            first = d["warmup_calls"] + d["first_move_after"]
            max_moves = max(0, (horizon - first) // d["move_every"] + 1)
        return cls(d["loop"], float(d.get("rate_hz", 0.0)), int(d["warmup_calls"]),
                   int(d["first_move_after"]), int(d["move_every"]), int(d.get("stagger", 0)),
                   int(d["hand_calls"]), int(max_moves), int(d["renders"]),
                   int(d["trace_calls"]))


def quiet_game(seed: int, board_index: int, moves: int) -> List["chess.Move"]:
    """``moves`` quiet legal moves from the starting position, drawn from
    (seed, board_index)."""
    rng = np.random.default_rng([seed, board_index])
    board = chess.Board()
    out = []
    for _ in range(moves):
        quiet = [m for m in board.legal_moves
                 if m.promotion is None and board.piece_at(m.to_square) is None
                 and not board.is_castling(m) and not board.is_en_passant(m)]
        if not quiet:
            break
        move = quiet[int(rng.integers(len(quiet)))]
        board.push(move)
        out.append(move)
    return out


class BoardScript:
    """One board's game and its scenes: positions 0..M (after each move) and
    one hand scene a move, so ``2M + 1`` scenes; ``state(c)`` is the scene
    index that call c shows."""

    def __init__(self, traffic: Traffic, seed: int, index: int):
        self.t = traffic
        self.index = index
        self.moves = quiet_game(seed, index, traffic.max_moves)
        self.boards = [chess.Board()]
        for m in self.moves:
            b = chess.Board(self.boards[-1].fen())
            b.push(m)
            self.boards.append(b)
        self.start = traffic.warmup_calls + traffic.first_move_after + traffic.stagger * index

    @property
    def n_scenes(self) -> int:
        return 2 * len(self.moves) + 1

    def scene(self, i: int):
        """(rules board, hand) of scene i: position i, or for i > M the hand
        of move i - M over the position after it."""
        m = len(self.moves)
        if i <= m:
            return self.boards[i], None
        k = i - m  # move k (1-based)
        move = self.moves[k - 1]
        sq = lambda s: (chess.square_file(s), chess.square_rank(s))  # noqa: E731
        return self.boards[k], (sq(move.from_square), sq(move.to_square))

    def state(self, call: int) -> int:
        t = self.t
        if call < self.start or not self.moves:
            return 0
        k, into = divmod(call - self.start, t.move_every)  # move k + 1 began `into` calls ago
        if k >= len(self.moves):
            return len(self.moves)
        return len(self.moves) + k + 1 if into < t.hand_calls else k + 1

    def commits_due(self, call: int) -> int:
        """Moves whose hand has left the board by call ``call``."""
        if call < self.start:
            return 0
        k, into = divmod(call - self.start, self.t.move_every)
        return min(len(self.moves), k + (1 if into >= self.t.hand_calls else 0))
