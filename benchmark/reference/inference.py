# Frozen copy of chessboard_vision_tpu_torch/session/inference.py at commit 9f9af32, for the
# benchmark's plain reference: imports rewritten to this folder, nothing else
# changed unless a "reference:" comment says so.
"""Shared occupancy-diff -> legal-move inference.

A verbatim port of the JAX package's session/inference.py (that module
cannot be imported without jax: its package __init__ pulls in the
device pipeline).

Behavioral model: reference game_session.py:227-265 (pair matching over
missing x extra plus a capture scan, ambiguity -> None), with one
documented fix: castling is resolved FIRST via the exact
2-vanished/2-appeared pattern (reference game_state.py:104-127). The
reference's pair matching finds 4 legal candidates for a castling diff
(when O-O is legal, Ke1f1/Ke1g1/Rh1f1/Rh1g1 all are) and rejects it as
ambiguous — the reference can never commit a castling move from vision.
"""

from __future__ import annotations

from typing import Optional, Set, Tuple

from . import chesslib as chess

Pos = Tuple[int, int]


def infer_move_from_diff(
    game,
    diff_missing: Set[Pos],
    diff_extra: Set[Pos],
    vision_occupied: Set[Pos],
    log=None,
) -> Optional["chess.Move"]:
    """Infer exactly one legal move from an occupancy diff, or None.

    ``game`` is a rules.GameState; positions are (file, rank) with a1=(0,0).
    """
    # Castling first: the only move whose diff is 2 vanished / 2 appeared.
    if len(diff_missing) == 2 and len(diff_extra) == 2:
        castle = game._detect_castling(set(diff_missing), set(diff_extra))
        if castle is not None and castle in game.board.legal_moves:
            return castle

    possible = []
    for orig in diff_missing:
        orig_sq = chess.square(orig[0], orig[1])
        for dest in diff_extra:
            dest_sq = chess.square(dest[0], dest[1])
            cand = chess.Move(orig_sq, dest_sq)
            if cand not in game.board.legal_moves:
                promo = chess.Move(orig_sq, dest_sq, promotion=chess.QUEEN)
                if promo in game.board.legal_moves:
                    cand = promo
            if cand in game.board.legal_moves:
                possible.append(cand)
    # Capture scan: 1 vanished / 0 appeared — the destination square stays
    # visually occupied (by the capturing piece), so look for legal
    # captures from each vanished square whose target reads occupied.
    for orig in diff_missing:
        orig_sq = chess.square(orig[0], orig[1])
        for move in game.board.legal_moves:
            if move.from_square == orig_sq and game.board.is_capture(move):
                d = (chess.square_file(move.to_square), chess.square_rank(move.to_square))
                if d in vision_occupied:
                    possible.append(move)
    unique = list(set(possible))
    if len(unique) == 1:
        return unique[0]
    if len(unique) > 1 and log is not None:
        log.info("ambiguous moves: %s", sorted(m.uci() for m in unique))
    return None
