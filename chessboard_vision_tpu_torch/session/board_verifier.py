"""Board verification: occupancy sanity checks before/while playing.

The port's own copy of chessboard_vision_tpu.session.board_verifier.

The reference ships an orphan board_verifiers.py whose InitialBoardVerifier
depends on a classifier that doesn't exist (SURVEY.md §2: "orphan, broken").
This module provides the capability it sketched, working against what the
vision stack actually produces (occupancy):

- InitialBoardVerifier: confidence that the detected occupancy matches the
  expected initial setup (ranks 1-2 and 7-8 occupied, middle empty), with a
  per-square report. Used to gate game start after reference capture.
- IncrementalBoardVerifier: checks a post-move occupancy against the rules
  board (exact-diff verification instead of the reference's placeholder
  returning True).
"""

from __future__ import annotations

from typing import Set, Tuple

from chessboard_vision_tpu_torch.rules import chess

SquareTuple = Tuple[int, int]


def expected_initial_occupancy() -> Set[SquareTuple]:
    return {(f, r) for f in range(8) for r in (0, 1, 6, 7)}


class InitialBoardVerifier:
    """Score detected occupancy against the initial position."""

    def __init__(self, threshold: float = 0.90):
        self.threshold = threshold

    def verify(self, vision_occupied: Set[SquareTuple]):
        """Returns (ok, confidence, report).

        confidence = fraction of the 64 squares whose occupancy state
        matches the initial setup; report lists mismatches.
        """
        expected = expected_initial_occupancy()
        missing = expected - set(vision_occupied)
        phantom = set(vision_occupied) - expected
        matches = 64 - len(missing) - len(phantom)
        confidence = matches / 64.0
        report = {
            "confidence": confidence,
            "missing": sorted(missing),
            "phantom": sorted(phantom),
        }
        return confidence >= self.threshold, confidence, report


class IncrementalBoardVerifier:
    """Verify vision occupancy against the authoritative rules board."""

    def __init__(self, board: "chess.Board"):
        self.board = board

    def expected_occupancy(self) -> Set[SquareTuple]:
        return {
            (chess.square_file(sq), chess.square_rank(sq))
            for sq in chess.SQUARES
            if self.board.piece_at(sq) is not None
        }

    def verify_move(self, vision_occupied: Set[SquareTuple], tolerance: int = 0):
        """True when vision matches the board within ``tolerance`` squares."""
        expected = self.expected_occupancy()
        diff = len(expected - set(vision_occupied)) + len(set(vision_occupied) - expected)
        return diff <= tolerance, diff
