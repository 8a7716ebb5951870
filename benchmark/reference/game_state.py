# Frozen copy of chessboard_vision_tpu_torch/rules/game_state.py at commit 9f9af32, for the
# benchmark's plain reference: imports rewritten to this folder, nothing else
# changed unless a "reference:" comment says so.
"""GameState — occupancy-delta to legal-move resolution.

Behavioral equivalent of reference game_state.py: wraps a rules Board as the
single source of truth and converts occupancy-set deltas from the vision
stack into legal chess moves. Covers the four reference patterns
(game_state.py:40-102): normal move (1 vanished / 1 appeared), castling
(2/2), en passant (2/1), and capture (1/0, with ambiguity rejection), plus
automatic queen promotion (game_state.py:176-195).
"""

from __future__ import annotations

from typing import Optional, Set, Tuple

from . import chesslib as chess

SquareTuple = Tuple[int, int]  # (file_idx, rank_idx), a1=(0,0), h8=(7,7)


class GameState:
    def __init__(self):
        self.board = chess.Board()
        # FEN of the position move_stack replays from (set_fen/reset update
        # it) — PGN export needs it for games digitized mid-position.
        self.start_fen = chess.STARTING_FEN

    def get_fen(self) -> str:
        return self.board.fen()

    def get_turn(self):
        return self.board.turn

    def get_turn_name(self) -> str:
        return "white" if self.board.turn == chess.WHITE else "black"

    def get_legal_moves(self):
        return list(self.board.legal_moves)

    def get_legal_moves_from(self, file: int, rank: int):
        src = chess.square(file, rank)
        return [m for m in self.board.legal_moves if m.from_square == src]

    def get_board_occupancy(self) -> Set[SquareTuple]:
        """Set of (file, rank) tuples currently occupied (ref game_state.py:26)."""
        occ = set()
        for sq in chess.SQUARES:
            if self.board.piece_at(sq) is not None:
                occ.add((chess.square_file(sq), chess.square_rank(sq)))
        return occ

    def process_occupancy_change(self, vision_occupancy: Set[SquareTuple]):
        """Resolve a vision occupancy set into a move (ref game_state.py:40).

        Returns (move_or_None_or_False, status_string).
        """
        logical = self.get_board_occupancy()
        vanished = logical - vision_occupancy
        appeared = vision_occupancy - logical
        n_v, n_a = len(vanished), len(appeared)

        if n_v == 1 and n_a == 1:
            src = next(iter(vanished))
            dst = next(iter(appeared))
            move = self._validate_move(src, dst)
            if move:
                self.board.push(move)
                return move, "move_confirmed"
            return None, "illegal_move"

        if n_v == 2 and n_a == 2:
            move = self._detect_castling(vanished, appeared)
            if move:
                self.board.push(move)
                return move, "castling_confirmed"

        if n_v == 2 and n_a == 1:
            move = self._detect_en_passant(vanished, appeared)
            if move:
                self.board.push(move)
                return move, "en_passant_confirmed"

        if n_v == 1 and n_a == 0:
            src = next(iter(vanished))
            move = self._detect_capture(src, vision_occupancy)
            if move:
                self.board.push(move)
                return move, "capture_confirmed"
            elif move is None:
                return None, "ambiguous_capture"

        return None, "no_valid_change"

    def _detect_castling(self, vanished, appeared) -> Optional[chess.Move]:
        """King moved two files horizontally among the vanished/appeared pairs."""
        for v in vanished:
            v_sq = chess.square(v[0], v[1])
            piece = self.board.piece_at(v_sq)
            if piece and piece.piece_type == chess.KING:
                for a in appeared:
                    if abs(a[0] - v[0]) == 2 and a[1] == v[1]:
                        move = chess.Move(v_sq, chess.square(a[0], a[1]))
                        if move in self.board.legal_moves:
                            return move
        return None

    def _detect_en_passant(self, vanished, appeared) -> Optional[chess.Move]:
        """Attacker pawn + victim pawn vanish; attacker appears diagonally."""
        dst = next(iter(appeared))
        dst_sq = chess.square(dst[0], dst[1])
        for src in vanished:
            src_sq = chess.square(src[0], src[1])
            piece = self.board.piece_at(src_sq)
            if piece and piece.piece_type == chess.PAWN:
                move = chess.Move(src_sq, dst_sq)
                if move in self.board.legal_moves and self.board.is_en_passant(move):
                    return move
        return None

    def _detect_capture(self, src: SquareTuple, vision_occupancy: Set[SquareTuple]):
        """One piece vanished, destination already occupied in vision.

        Returns the unique candidate move, None when ambiguous, False when no
        candidate exists (matching reference game_state.py:153-174).
        """
        src_sq = chess.square(src[0], src[1])
        candidates = []
        for move in self.board.legal_moves:
            if move.from_square == src_sq and self.board.is_capture(move):
                dst = (chess.square_file(move.to_square), chess.square_rank(move.to_square))
                if dst in vision_occupancy:
                    candidates.append(move)
        if len(candidates) == 1:
            return candidates[0]
        elif len(candidates) > 1:
            return None
        return False

    def _validate_move(self, src: SquareTuple, dst: SquareTuple) -> Optional[chess.Move]:
        src_sq = chess.square(src[0], src[1])
        dst_sq = chess.square(dst[0], dst[1])
        move = chess.Move(src_sq, dst_sq)
        if move in self.board.legal_moves:
            return move
        promo = chess.Move(src_sq, dst_sq, promotion=chess.QUEEN)
        if promo in self.board.legal_moves:
            return promo
        return None

    def reset(self):
        self.board.reset()
        self.start_fen = chess.STARTING_FEN

    def set_fen(self, fen: str):
        self.board.set_fen(fen)
        self.start_fen = fen
