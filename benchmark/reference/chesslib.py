# Frozen copy of chessboard_vision_tpu_torch/rules/chesslib.py at commit 9f9af32, for the
# benchmark's plain reference: imports rewritten to this folder, nothing else
# changed unless a "reference:" comment says so.
"""A compact, correct chess rules engine (python-chess API subset).

The reference app (reference game_state.py, game_session.py,
lichess_session.py) leans on the external ``python-chess`` package for the
board model, legal-move generation, and FEN. This module is a from-scratch
implementation of exactly the subset that the vision framework needs, with
the same square numbering (a1=0 .. h8=63), the same ``Move``/``Piece``
semantics, and the same method names, so the higher layers read identically
to the reference call sites.

Design: 8x8 mailbox board (list of 64 Optional[Piece]); pseudo-legal move
generation per piece with ray walks; legality by make/unmake + own-king
attack test. Perft-validated (see tests/test_chesslib.py).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

# --- Colors -----------------------------------------------------------------
WHITE = True
BLACK = False

# --- Piece types ------------------------------------------------------------
PAWN, KNIGHT, BISHOP, ROOK, QUEEN, KING = range(1, 7)
PIECE_SYMBOLS = [None, "p", "n", "b", "r", "q", "k"]
PIECE_NAMES = [None, "pawn", "knight", "bishop", "rook", "queen", "king"]

# --- Squares ----------------------------------------------------------------
SQUARES = list(range(64))
FILE_NAMES = ["a", "b", "c", "d", "e", "f", "g", "h"]
RANK_NAMES = ["1", "2", "3", "4", "5", "6", "7", "8"]

# Named square constants (A1..H8), generated to mirror python-chess.
for _r in range(8):
    for _f in range(8):
        globals()[f"{FILE_NAMES[_f].upper()}{_r + 1}"] = _r * 8 + _f
del _r, _f


def square(file_index: int, rank_index: int) -> int:
    """Return the square index for (file, rank), both 0-indexed."""
    return rank_index * 8 + file_index


def square_file(sq: int) -> int:
    return sq & 7


def square_rank(sq: int) -> int:
    return sq >> 3


def square_name(sq: int) -> str:
    return FILE_NAMES[square_file(sq)] + RANK_NAMES[square_rank(sq)]


def parse_square(name: str) -> int:
    return square(FILE_NAMES.index(name[0]), RANK_NAMES.index(name[1]))


STARTING_FEN = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"


class Piece:
    """A chess piece: type (PAWN..KING) + color (WHITE/BLACK)."""

    __slots__ = ("piece_type", "color")

    def __init__(self, piece_type: int, color: bool):
        self.piece_type = piece_type
        self.color = color

    def symbol(self) -> str:
        s = PIECE_SYMBOLS[self.piece_type]
        return s.upper() if self.color == WHITE else s

    @classmethod
    def from_symbol(cls, symbol: str) -> "Piece":
        return cls(PIECE_SYMBOLS.index(symbol.lower()), symbol.isupper())

    def __eq__(self, other):
        return (
            isinstance(other, Piece)
            and self.piece_type == other.piece_type
            and self.color == other.color
        )

    def __hash__(self):
        return hash((self.piece_type, self.color))

    def __repr__(self):
        return f"Piece.from_symbol({self.symbol()!r})"


class Move:
    """A move from one square to another, with optional promotion."""

    __slots__ = ("from_square", "to_square", "promotion")

    def __init__(self, from_square: int, to_square: int, promotion: Optional[int] = None):
        self.from_square = from_square
        self.to_square = to_square
        self.promotion = promotion

    def uci(self) -> str:
        u = square_name(self.from_square) + square_name(self.to_square)
        if self.promotion:
            u += PIECE_SYMBOLS[self.promotion]
        return u

    @classmethod
    def from_uci(cls, uci: str) -> "Move":
        if not 4 <= len(uci) <= 5:
            raise ValueError(f"invalid uci: {uci!r}")
        promotion = PIECE_SYMBOLS.index(uci[4]) if len(uci) == 5 else None
        return cls(parse_square(uci[0:2]), parse_square(uci[2:4]), promotion)

    def __eq__(self, other):
        return (
            isinstance(other, Move)
            and self.from_square == other.from_square
            and self.to_square == other.to_square
            and self.promotion == other.promotion
        )

    def __hash__(self):
        return hash((self.from_square, self.to_square, self.promotion))

    def __repr__(self):
        return f"Move.from_uci({self.uci()!r})"


# Knight and king step offsets as (dfile, drank) pairs.
_KNIGHT_STEPS = [(1, 2), (2, 1), (2, -1), (1, -2), (-1, -2), (-2, -1), (-2, 1), (-1, 2)]
_KING_STEPS = [(1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1)]
_BISHOP_DIRS = [(1, 1), (-1, 1), (-1, -1), (1, -1)]
_ROOK_DIRS = [(1, 0), (-1, 0), (0, 1), (0, -1)]

# Castling-rights bit flags.
_CR_WK, _CR_WQ, _CR_BK, _CR_BQ = 1, 2, 4, 8


class _Undo:
    __slots__ = (
        "move",
        "captured",
        "captured_sq",
        "castling",
        "ep_square",
        "halfmove",
        "fullmove",
        "was_castle_rook",
    )


class _LegalMoveList:
    """Lazy view over legal moves supporting ``in``, ``iter`` and ``list()``."""

    def __init__(self, board: "Board"):
        self._board = board

    def __iter__(self) -> Iterator[Move]:
        return self._board._generate_legal_moves()

    def __contains__(self, move: Move) -> bool:
        return self._board.is_legal(move)

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def __repr__(self):
        return f"<LegalMoveList ({', '.join(m.uci() for m in self)})>"


class Board:
    """Mutable chess position with legal-move generation and FEN I/O."""

    def __init__(self, fen: Optional[str] = STARTING_FEN):
        self.move_stack: List[Move] = []
        self._undo_stack: List[_Undo] = []
        if fen is None:
            self.clear()
        else:
            self.set_fen(fen)

    # --- setup -------------------------------------------------------------

    def clear(self):
        self._pieces: List[Optional[Piece]] = [None] * 64
        self.turn = WHITE
        self._castling = 0
        self.ep_square: Optional[int] = None
        self.halfmove_clock = 0
        self.fullmove_number = 1
        self.move_stack.clear()
        self._undo_stack.clear()
        self._position_counts = {self._position_key(): 1}

    def reset(self):
        self.set_fen(STARTING_FEN)

    def set_fen(self, fen: str):
        parts = fen.split()
        if len(parts) < 4:
            raise ValueError(f"invalid fen: {fen!r}")
        placement, turn, castling, ep = parts[0], parts[1], parts[2], parts[3]
        halfmove = int(parts[4]) if len(parts) > 4 else 0
        fullmove = int(parts[5]) if len(parts) > 5 else 1

        pieces: List[Optional[Piece]] = [None] * 64
        rows = placement.split("/")
        if len(rows) != 8:
            raise ValueError(f"invalid fen placement: {placement!r}")
        for rank_from_top, row in enumerate(rows):
            rank = 7 - rank_from_top
            file = 0
            for ch in row:
                if ch.isdigit():
                    file += int(ch)
                else:
                    pieces[square(file, rank)] = Piece.from_symbol(ch)
                    file += 1
            if file != 8:
                raise ValueError(f"invalid fen row: {row!r}")

        self._pieces = pieces
        self.turn = turn == "w"
        self._castling = 0
        if "K" in castling:
            self._castling |= _CR_WK
        if "Q" in castling:
            self._castling |= _CR_WQ
        if "k" in castling:
            self._castling |= _CR_BK
        if "q" in castling:
            self._castling |= _CR_BQ
        self.ep_square = None if ep == "-" else parse_square(ep)
        self.halfmove_clock = halfmove
        self.fullmove_number = fullmove
        self.move_stack.clear()
        self._undo_stack.clear()
        self._position_counts = {self._position_key(): 1}

    def fen(self) -> str:
        rows = []
        for rank in range(7, -1, -1):
            row = ""
            empty = 0
            for file in range(8):
                p = self._pieces[square(file, rank)]
                if p is None:
                    empty += 1
                else:
                    if empty:
                        row += str(empty)
                        empty = 0
                    row += p.symbol()
            if empty:
                row += str(empty)
            rows.append(row)
        castling = ""
        if self._castling & _CR_WK:
            castling += "K"
        if self._castling & _CR_WQ:
            castling += "Q"
        if self._castling & _CR_BK:
            castling += "k"
        if self._castling & _CR_BQ:
            castling += "q"
        ep = square_name(self.ep_square) if self.ep_square is not None else "-"
        return " ".join(
            [
                "/".join(rows),
                "w" if self.turn else "b",
                castling or "-",
                ep,
                str(self.halfmove_clock),
                str(self.fullmove_number),
            ]
        )

    # --- queries -----------------------------------------------------------

    def piece_at(self, sq: int) -> Optional[Piece]:
        return self._pieces[sq]

    def king(self, color: bool) -> Optional[int]:
        for sq in range(64):
            p = self._pieces[sq]
            if p is not None and p.piece_type == KING and p.color == color:
                return sq
        return None

    def is_attacked_by(self, color: bool, sq: int) -> bool:
        """True if any piece of ``color`` attacks ``sq``."""
        f, r = square_file(sq), square_rank(sq)
        pieces = self._pieces

        # Pawn attacks: a pawn of `color` attacks sq if it sits one rank
        # behind (from color's perspective) on an adjacent file.
        dr = -1 if color == WHITE else 1
        for df in (-1, 1):
            nf, nr = f + df, r + dr
            if 0 <= nf < 8 and 0 <= nr < 8:
                p = pieces[square(nf, nr)]
                if p is not None and p.color == color and p.piece_type == PAWN:
                    return True

        for df, dr in _KNIGHT_STEPS:
            nf, nr = f + df, r + dr
            if 0 <= nf < 8 and 0 <= nr < 8:
                p = pieces[square(nf, nr)]
                if p is not None and p.color == color and p.piece_type == KNIGHT:
                    return True

        for df, dr in _KING_STEPS:
            nf, nr = f + df, r + dr
            if 0 <= nf < 8 and 0 <= nr < 8:
                p = pieces[square(nf, nr)]
                if p is not None and p.color == color and p.piece_type == KING:
                    return True

        for dirs, sliders in (
            (_BISHOP_DIRS, (BISHOP, QUEEN)),
            (_ROOK_DIRS, (ROOK, QUEEN)),
        ):
            for df, dr in dirs:
                nf, nr = f + df, r + dr
                while 0 <= nf < 8 and 0 <= nr < 8:
                    p = pieces[square(nf, nr)]
                    if p is not None:
                        if p.color == color and p.piece_type in sliders:
                            return True
                        break
                    nf += df
                    nr += dr
        return False

    def is_check(self) -> bool:
        ksq = self.king(self.turn)
        return ksq is not None and self.is_attacked_by(not self.turn, ksq)

    def is_checkmate(self) -> bool:
        return self.is_check() and not any(self._generate_legal_moves())

    def is_stalemate(self) -> bool:
        return not self.is_check() and not any(self._generate_legal_moves())

    # --- draw adjudication ---------------------------------------------------
    # The reference inherited this surface from python-chess
    # (reference game_state.py:1 `import chess`); the vision framework
    # needs it so a digitized drawn game exports 1/2-1/2 (rules/pgn.py)
    # instead of '*'. Semantics mirror python-chess: is_* are the
    # automatic forms, can_claim_* the claimable forms.

    def _has_legal_en_passant(self) -> bool:
        """True if an en-passant capture is actually legal right now —
        FIDE repetition rules only distinguish positions by ep square
        when the capture is playable."""
        if self.ep_square is None:
            return False
        f, r = square_file(self.ep_square), square_rank(self.ep_square)
        cap_r = r - 1 if self.turn == WHITE else r + 1
        if not 0 <= cap_r < 8:
            return False
        for df in (-1, 1):
            nf = f + df
            if 0 <= nf < 8:
                p = self._pieces[square(nf, cap_r)]
                if (
                    p is not None
                    and p.color == self.turn
                    and p.piece_type == PAWN
                    and self.is_legal(Move(square(nf, cap_r), self.ep_square))
                ):
                    return True
        return False

    def _position_key(self):
        """Hashable FIDE-equivalence key: placement, side to move,
        castling rights, and the ep square only when capturable."""
        return (
            tuple(
                None if p is None else (p.piece_type, p.color)
                for p in self._pieces
            ),
            self.turn,
            self._castling,
            self.ep_square if self._has_legal_en_passant() else None,
        )

    def is_repetition(self, count: int = 3) -> bool:
        """True if the current position has occurred ``count`` times over
        the pushed move sequence (including the start position)."""
        return self._position_counts.get(self._position_key(), 0) >= count

    def can_claim_threefold_repetition(self) -> bool:
        return self.is_repetition(3)

    def is_fifty_moves(self) -> bool:
        """100+ halfmoves without pawn move or capture, game not already
        ended by those same moves (a mate on the 100th halfmove wins)."""
        return self.halfmove_clock >= 100 and any(self._generate_legal_moves())

    def can_claim_fifty_moves(self) -> bool:
        return self.is_fifty_moves()

    def can_claim_draw(self) -> bool:
        return self.can_claim_fifty_moves() or self.can_claim_threefold_repetition()

    def is_seventyfive_moves(self) -> bool:
        """FIDE 9.6b AUTOMATIC draw: 150 halfmoves without pawn move or
        capture (a mate delivered by the 150th halfmove still wins)."""
        return self.halfmove_clock >= 150 and any(self._generate_legal_moves())

    def is_fivefold_repetition(self) -> bool:
        """FIDE 9.6a AUTOMATIC draw: the same position five times."""
        return self.is_repetition(5)

    def is_insufficient_material(self) -> bool:
        """Dead-position material test (python-chess semantics): K vs K,
        a single minor piece, or bishops-only all on one square color."""
        minors = []
        for sq in range(64):
            p = self._pieces[sq]
            if p is None or p.piece_type == KING:
                continue
            if p.piece_type in (PAWN, ROOK, QUEEN):
                return False
            minors.append((p.piece_type, sq))
        if len(minors) <= 1:
            return True
        if any(pt == KNIGHT for pt, _ in minors):
            return False
        shades = {(square_file(sq) + square_rank(sq)) & 1 for _, sq in minors}
        return len(shades) == 1

    def is_game_over(self, claim_draw: bool = False) -> bool:
        if not any(self._generate_legal_moves()):
            return True  # checkmate or stalemate
        if self.is_insufficient_material():
            return True
        # Automatic FIDE 9.6 terminations end the game without a claim
        # (legal moves are known to exist here, so the seventyfive-moves
        # mate carve-out is already satisfied).
        if self.halfmove_clock >= 150 or self.is_fivefold_repetition():
            return True
        return claim_draw and self.can_claim_draw()

    # --- move generation ---------------------------------------------------

    def _generate_pseudo_legal(self) -> Iterator[Move]:
        us = self.turn
        pieces = self._pieces
        for sq in range(64):
            p = pieces[sq]
            if p is None or p.color != us:
                continue
            f, r = square_file(sq), square_rank(sq)
            pt = p.piece_type

            if pt == PAWN:
                fwd = 1 if us == WHITE else -1
                start_rank = 1 if us == WHITE else 6
                promo_rank = 7 if us == WHITE else 0
                one = r + fwd
                if 0 <= one < 8 and pieces[square(f, one)] is None:
                    if one == promo_rank:
                        for promo in (QUEEN, ROOK, BISHOP, KNIGHT):
                            yield Move(sq, square(f, one), promo)
                    else:
                        yield Move(sq, square(f, one))
                        if r == start_rank and pieces[square(f, r + 2 * fwd)] is None:
                            yield Move(sq, square(f, r + 2 * fwd))
                for df in (-1, 1):
                    nf = f + df
                    if not (0 <= nf < 8 and 0 <= one < 8):
                        continue
                    target_sq = square(nf, one)
                    tp = pieces[target_sq]
                    if tp is not None and tp.color != us:
                        if one == promo_rank:
                            for promo in (QUEEN, ROOK, BISHOP, KNIGHT):
                                yield Move(sq, target_sq, promo)
                        else:
                            yield Move(sq, target_sq)
                    elif target_sq == self.ep_square:
                        yield Move(sq, target_sq)

            elif pt == KNIGHT:
                for df, dr in _KNIGHT_STEPS:
                    nf, nr = f + df, r + dr
                    if 0 <= nf < 8 and 0 <= nr < 8:
                        tp = pieces[square(nf, nr)]
                        if tp is None or tp.color != us:
                            yield Move(sq, square(nf, nr))

            elif pt == KING:
                for df, dr in _KING_STEPS:
                    nf, nr = f + df, r + dr
                    if 0 <= nf < 8 and 0 <= nr < 8:
                        tp = pieces[square(nf, nr)]
                        if tp is None or tp.color != us:
                            yield Move(sq, square(nf, nr))
                yield from self._generate_castling(sq)

            else:
                dirs = (
                    _BISHOP_DIRS
                    if pt == BISHOP
                    else _ROOK_DIRS
                    if pt == ROOK
                    else _BISHOP_DIRS + _ROOK_DIRS
                )
                for df, dr in dirs:
                    nf, nr = f + df, r + dr
                    while 0 <= nf < 8 and 0 <= nr < 8:
                        tp = pieces[square(nf, nr)]
                        if tp is None:
                            yield Move(sq, square(nf, nr))
                        else:
                            if tp.color != us:
                                yield Move(sq, square(nf, nr))
                            break
                        nf += df
                        nr += dr

    def _generate_castling(self, king_sq: int) -> Iterator[Move]:
        us = self.turn
        them = not us
        rank = 0 if us == WHITE else 7
        if king_sq != square(4, rank):
            return
        if self.is_attacked_by(them, king_sq):
            return
        pieces = self._pieces
        # Kingside
        if self._castling & (_CR_WK if us == WHITE else _CR_BK):
            rook_sq = square(7, rank)
            rp = pieces[rook_sq]
            if (
                rp is not None
                and rp.piece_type == ROOK
                and rp.color == us
                and pieces[square(5, rank)] is None
                and pieces[square(6, rank)] is None
                and not self.is_attacked_by(them, square(5, rank))
                and not self.is_attacked_by(them, square(6, rank))
            ):
                yield Move(king_sq, square(6, rank))
        # Queenside
        if self._castling & (_CR_WQ if us == WHITE else _CR_BQ):
            rook_sq = square(0, rank)
            rp = pieces[rook_sq]
            if (
                rp is not None
                and rp.piece_type == ROOK
                and rp.color == us
                and pieces[square(1, rank)] is None
                and pieces[square(2, rank)] is None
                and pieces[square(3, rank)] is None
                and not self.is_attacked_by(them, square(3, rank))
                and not self.is_attacked_by(them, square(2, rank))
            ):
                yield Move(king_sq, square(2, rank))

    def _generate_legal_moves(self) -> Iterator[Move]:
        us = self.turn
        for move in list(self._generate_pseudo_legal()):
            self._do_move(move)
            ksq = self.king(us)
            safe = ksq is not None and not self.is_attacked_by(not us, ksq)
            self._undo_move()
            if safe:
                yield move

    @property
    def legal_moves(self) -> _LegalMoveList:
        return _LegalMoveList(self)

    def is_legal(self, move: Move) -> bool:
        p = self._pieces[move.from_square]
        if p is None or p.color != self.turn:
            return False
        # Promotion normalization: a pawn reaching the last rank must promote.
        if p.piece_type == PAWN and square_rank(move.to_square) in (0, 7):
            if move.promotion is None:
                return False
        elif move.promotion is not None:
            return False
        for cand in self._generate_pseudo_legal():
            if cand == move:
                self._do_move(move)
                ksq = self.king(not self.turn)
                safe = ksq is not None and not self.is_attacked_by(self.turn, ksq)
                self._undo_move()
                return safe
        return False

    # --- move classification ------------------------------------------------

    def is_en_passant(self, move: Move) -> bool:
        p = self._pieces[move.from_square]
        return (
            p is not None
            and p.piece_type == PAWN
            and self.ep_square is not None
            and move.to_square == self.ep_square
            and self._pieces[move.to_square] is None
            and square_file(move.from_square) != square_file(move.to_square)
        )

    def is_capture(self, move: Move) -> bool:
        target = self._pieces[move.to_square]
        return (target is not None and target.color != self.turn) or self.is_en_passant(move)

    def is_castling(self, move: Move) -> bool:
        p = self._pieces[move.from_square]
        return (
            p is not None
            and p.piece_type == KING
            and abs(square_file(move.to_square) - square_file(move.from_square)) == 2
        )

    # --- make / unmake -----------------------------------------------------

    def _do_move(self, move: Move):
        undo = _Undo()
        undo.move = move
        undo.castling = self._castling
        undo.ep_square = self.ep_square
        undo.halfmove = self.halfmove_clock
        undo.fullmove = self.fullmove_number
        undo.was_castle_rook = None

        pieces = self._pieces
        p = pieces[move.from_square]
        captured = pieces[move.to_square]
        captured_sq = move.to_square

        is_ep = self.is_en_passant(move)
        if is_ep:
            captured_sq = square(square_file(move.to_square), square_rank(move.from_square))
            captured = pieces[captured_sq]
            pieces[captured_sq] = None

        undo.captured = captured
        undo.captured_sq = captured_sq

        pieces[move.from_square] = None
        if move.promotion:
            pieces[move.to_square] = Piece(move.promotion, p.color)
        else:
            pieces[move.to_square] = p

        # Castling rook relocation.
        if p.piece_type == KING and abs(square_file(move.to_square) - square_file(move.from_square)) == 2:
            rank = square_rank(move.from_square)
            if square_file(move.to_square) == 6:  # kingside
                rook_from, rook_to = square(7, rank), square(5, rank)
            else:  # queenside
                rook_from, rook_to = square(0, rank), square(3, rank)
            pieces[rook_to] = pieces[rook_from]
            pieces[rook_from] = None
            undo.was_castle_rook = (rook_from, rook_to)

        # Castling-rights updates.
        cr = self._castling
        if p.piece_type == KING:
            cr &= ~((_CR_WK | _CR_WQ) if p.color == WHITE else (_CR_BK | _CR_BQ))
        for s, flag in (
            (square(7, 0), _CR_WK),
            (square(0, 0), _CR_WQ),
            (square(7, 7), _CR_BK),
            (square(0, 7), _CR_BQ),
        ):
            if move.from_square == s or captured_sq == s:
                cr &= ~flag
        self._castling = cr

        # En-passant target square.
        if p.piece_type == PAWN and abs(square_rank(move.to_square) - square_rank(move.from_square)) == 2:
            self.ep_square = square(
                square_file(move.from_square),
                (square_rank(move.from_square) + square_rank(move.to_square)) // 2,
            )
        else:
            self.ep_square = None

        if p.piece_type == PAWN or captured is not None:
            self.halfmove_clock = 0
        else:
            self.halfmove_clock += 1
        if self.turn == BLACK:
            self.fullmove_number += 1
        self.turn = not self.turn
        self._undo_stack.append(undo)

    def _undo_move(self):
        undo = self._undo_stack.pop()
        move = undo.move
        pieces = self._pieces
        p = pieces[move.to_square]
        if move.promotion:
            p = Piece(PAWN, p.color)
        pieces[move.from_square] = p
        pieces[move.to_square] = None
        if undo.captured is not None:
            pieces[undo.captured_sq] = undo.captured
        if undo.was_castle_rook is not None:
            rook_from, rook_to = undo.was_castle_rook
            pieces[rook_from] = pieces[rook_to]
            pieces[rook_to] = None
        self._castling = undo.castling
        self.ep_square = undo.ep_square
        self.halfmove_clock = undo.halfmove
        self.fullmove_number = undo.fullmove
        self.turn = not self.turn

    def push(self, move: Move):
        """Make a move (must be legal for correct semantics)."""
        self._do_move(move)
        self.move_stack.append(move)
        key = self._position_key()
        self._position_counts[key] = self._position_counts.get(key, 0) + 1

    def pop(self) -> Move:
        key = self._position_key()
        n = self._position_counts.get(key, 0) - 1
        if n > 0:
            self._position_counts[key] = n
        else:
            self._position_counts.pop(key, None)
        self._undo_move()
        return self.move_stack.pop()

    def peek(self) -> Move:
        return self.move_stack[-1]

    def push_uci(self, uci: str) -> Move:
        move = Move.from_uci(uci)
        # Normalize: bare pawn move to last rank defaults like python-chess
        # would reject; Lichess always includes the promotion suffix.
        if not self.is_legal(move):
            raise ValueError(f"illegal uci move {uci!r} in {self.fen()!r}")
        self.push(move)
        return move

    # --- misc ---------------------------------------------------------------

    def __repr__(self):
        return f"Board({self.fen()!r})"

    def __str__(self):
        rows = []
        for rank in range(7, -1, -1):
            row = []
            for file in range(8):
                p = self._pieces[square(file, rank)]
                row.append(p.symbol() if p else ".")
            rows.append(" ".join(row))
        return "\n".join(rows)


def perft(board: Board, depth: int) -> int:
    """Node count to ``depth`` — used by the engine's correctness tests.

    Uses the raw make/unmake (not push/pop) so the repetition-counter
    bookkeeping doesn't tax the hot enumeration."""
    if depth == 0:
        return 1
    total = 0
    for move in board.legal_moves:
        board._do_move(move)
        total += perft(board, depth - 1)
        board._undo_move()
    return total
