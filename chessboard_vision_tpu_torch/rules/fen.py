"""FEN generation from labeled detections or occupancy grids.

Equivalent of the reference's standalone FEN API (fen_generator.py): maps
pixel-space detections onto the 8x8 grid with confidence-based conflict
resolution and serializes a FEN placement string. Adds
``occupancy_to_fen`` used by the TPU pipeline's frame->FEN path.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np

COLUMNS = "abcdefgh"
ROWS = "12345678"

PIECE_TO_FEN = {
    "white-pawn": "P", "white-knight": "N", "white-bishop": "B",
    "white-rook": "R", "white-queen": "Q", "white-king": "K",
    "black-pawn": "p", "black-knight": "n", "black-bishop": "b",
    "black-rook": "r", "black-queen": "q", "black-king": "k",
}


def get_chess_square(x: int, y: int, board_size: int) -> Tuple[str, Tuple[int, int]]:
    """Pixel (x, y) in the warped image -> (square name, (grid_x, grid_y)).

    grid_y counts from the top (0 = rank 8), as in reference
    fen_generator.py:12-30.
    """
    square_size = board_size // 8
    grid_x = x // square_size
    grid_y = y // square_size
    if not (0 <= grid_x < 8 and 0 <= grid_y < 8):
        return "out_of_bounds", (-1, -1)
    return f"{COLUMNS[grid_x]}{ROWS[7 - grid_y]}", (grid_x, grid_y)


def map_detections_to_board(detections: Iterable[dict], board_size: int) -> Dict:
    """Map labeled detections to grid cells, keeping highest confidence on conflict."""
    board_map: Dict[Tuple[int, int], dict] = {}
    for det in detections:
        cx, cy = det["center"]
        _, (gx, gy) = get_chess_square(cx, cy, board_size)
        if gx == -1:
            continue
        entry = {
            "fen": PIECE_TO_FEN.get(det["class"], "?"),
            "conf": det["conf"],
            "class": det["class"],
        }
        if (gx, gy) not in board_map or det["conf"] > board_map[(gx, gy)]["conf"]:
            board_map[(gx, gy)] = entry
    return board_map


def generate_fen(board_map: Dict, current_turn: str = "w") -> str:
    """Serialize a {(grid_x, grid_y): {'fen': char}} map into a FEN string.

    Castling/en-passant fields are stubbed ``- -`` as in the reference
    (fen_generator.py:86-89).
    """
    board = [["" for _ in range(8)] for _ in range(8)]
    for (gx, gy), data in board_map.items():
        board[gy][gx] = data["fen"]

    fen_rows = []
    for row in board:
        empty = 0
        row_fen = ""
        for cell in row:
            if cell == "":
                empty += 1
            else:
                if empty:
                    row_fen += str(empty)
                    empty = 0
                row_fen += cell
        if empty:
            row_fen += str(empty)
        fen_rows.append(row_fen)
    return f"{'/'.join(fen_rows)} {current_turn} - - 0 1"


def _otsu_split(vals, scale):
    """1-D Otsu over float values binned at ``scale`` units/bin (256 bins).

    Returns a boolean upper-class mask (bin > argmax bin — values inside
    the threshold bin go to the LOWER class, cv2 convention)."""
    bins = np.clip(np.floor(vals / scale), 0, 255).astype(np.int64)
    hist = np.bincount(bins, minlength=256).astype(np.float64)
    p = hist / vals.size
    omega = np.cumsum(p)
    mu = np.cumsum(p * np.arange(256))
    mu_t = mu[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        sigma_b = (mu_t * omega - mu) ** 2 / (omega * (1.0 - omega))
    sigma_b[~np.isfinite(sigma_b)] = 0.0
    return bins > int(np.argmax(sigma_b))


def classify_piece_colors(
    center_means,
    occupancy,
    corner_means=None,
    min_gap: float = 40.0,
    min_ratio_gap: float = 0.30,
):
    """Light/dark piece classification from per-square region means.

    The reference sketched a piece classifier (fen_generator.py:5-10 maps
    'white-*'/'black-*' labels to FEN chars) but never shipped one; this is
    the promised vision-side half. ``center_means`` is the pipeline's
    StepOutputs.center_mean — the mean preprocessed-gray intensity over
    each square's center disc (the piece footprint); ``occupancy`` a (64,)
    bool in chess-index order.

    With ``corner_means`` (StepOutputs.corner_mean — the square's exposed
    background), each piece is scored by center/corner, which cancels
    shadow and glare: illumination shifts move both regions together, so
    the ratio stays cluster-separated where absolute means cross over
    (measured on the tests/test_regression_clip.py 'shadow' clip).
    Without it, absolute center means are used.

    Occupied squares split light-vs-dark by Otsu over their scores. Otsu
    always manufactures a boundary, so when the resulting class separation
    is under ``min_gap`` intensity levels (or ``min_ratio_gap`` in ratio
    mode) — one-color armies, e.g. every piece of one side captured — all
    pieces classify against a fixed midpoint (128 absolute / 1.0 ratio)
    instead.

    Returns a (64,) int8 array: 1 = light piece, 0 = dark piece,
    -1 = empty square.
    """
    means = np.asarray(center_means, np.float64).reshape(64)
    occ = np.asarray(occupancy, bool).reshape(64)
    out = np.full(64, -1, np.int8)
    if corner_means is not None:
        bg = np.maximum(np.asarray(corner_means, np.float64).reshape(64), 1.0)
        scores = means / bg
        midpoint, gap, bin_scale = 1.0, min_ratio_gap, 4.0 / 256.0
    else:
        scores = means
        midpoint, gap, bin_scale = 128.0, min_gap, 1.0
    vals = scores[occ]
    if vals.size == 0:
        return out
    if vals.size == 1:
        out[occ] = 1 if vals[0] >= midpoint else 0
        return out

    upper = _otsu_split(vals, bin_scale)
    lo, hi = vals[~upper], vals[upper]
    if lo.size == 0 or hi.size == 0 or (hi.mean() - lo.mean()) < gap:
        out[occ] = (vals >= midpoint).astype(np.int8)
    else:
        out[occ] = upper.astype(np.int8)
    return out


def occupancy_to_colored_fen(
    occupancy, piece_colors, current_turn: str = "w",
    light_char: str = "P", dark_char: str = "p",
) -> str:
    """FEN placement with light/dark piece colors.

    ``occupancy``: (8, 8) bool [file, rank] (or reshapeable);
    ``piece_colors``: (64,) int8 from ``classify_piece_colors`` (chess-index
    order: sq = rank*8 + file). Light pieces render as ``light_char``,
    dark as ``dark_char`` (pawn placeholders — occupancy+color is the full
    vision signal; piece *types* come from game-state tracking).
    """
    occ = np.asarray(occupancy, dtype=bool).reshape(8, 8)
    colors = np.asarray(piece_colors).reshape(64)
    board_map = {}
    for f in range(8):
        for r in range(8):
            if occ[f, r]:
                ch = light_char if colors[r * 8 + f] == 1 else dark_char
                board_map[(f, 7 - r)] = {"fen": ch, "conf": 1.0, "class": "occ"}
    return generate_fen(board_map, current_turn)


def occupancy_to_fen(occupancy, current_turn: str = "w", piece_char: str = "P") -> str:
    """FEN placement from a bare occupancy grid (no piece-type classifier).

    ``occupancy`` is an (8, 8) boolean array indexed [file, rank] (a1 =
    [0, 0]) or any array-like reshapeable to that. Occupied squares are
    rendered as ``piece_char``; this gives the frame->FEN path a canonical,
    comparable serialization even without a piece-type model (the reference
    has none either — occupancy is its only vision signal).
    """
    occ = np.asarray(occupancy, dtype=bool).reshape(8, 8)
    board_map = {}
    for f in range(8):
        for r in range(8):
            if occ[f, r]:
                # grid_y counts from top: rank r -> row (7 - r)
                board_map[(f, 7 - r)] = {"fen": piece_char, "conf": 1.0, "class": "occ"}
    return generate_fen(board_map, current_turn)
