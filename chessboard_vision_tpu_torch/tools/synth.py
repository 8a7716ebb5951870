"""Synthetic camera frames of a chessboard, rendered with numpy alone.

A top-down board (light/dark squares, pieces as filled discs with a dark
outline, white on ranks 1-4 and black on ranks 5-8 unless per-square colors
are given) is projected into a camera frame at four calibration corners
(TL, TR, BL, BR) by an inverse homography with bilinear sampling, over a
flat background, plus Gaussian sensor noise. Lets the vision path be driven
end to end without a camera. ``board_render_maps`` gives a rules board's
per-square piece colors and per-type disc radii (PIECE_RADIUS_FRAC, the
fractions of tests/fixtures.py), so piece types can be read off the frames.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from chessboard_vision_tpu_torch.geometry import get_perspective_transform

LIGHT = (181, 217, 240)
DARK = (99, 136, 181)
WHITE_PIECE = (235, 235, 245)
BLACK_PIECE = (40, 36, 30)
OUTLINE = (20, 20, 20)
PIECE_FRAC = 0.36  # disc radius / square side
# Per-type disc radii, a fraction of the square side: a Staunton spread
# inside the detector's 20%-55% Hough band.
PIECE_RADIUS_FRAC = {"p": 0.22, "n": 0.27, "b": 0.32, "r": 0.37, "q": 0.43, "k": 0.50}
BOARD_NOISE, FRAME_NOISE = 3.0, 2.0  # Gaussian sigmas (intensity levels)
BACKGROUND = 60


def bench_corners(height: int, width: int) -> np.ndarray:
    """The benchmark's board layout: an axis-aligned board of side
    min(h, w) - 100 centered in the frame. Corners TL, TR, BL, BR."""
    bs = min(height, width) - 100
    x0, y0 = (width - bs) // 2, (height - bs) // 2
    return np.array([[x0, y0], [x0 + bs, y0], [x0, y0 + bs], [x0 + bs, y0 + bs]])


def board_render_maps(board):
    """(occupancy, piece colors, radius fractions), each (8, 8) [file, rank],
    of a rules board: the true piece colors and per-type disc radii."""
    from chessboard_vision_tpu_torch.rules import chess

    occ = np.zeros((8, 8), bool)
    colors = np.empty((8, 8), object)
    radii = np.zeros((8, 8), np.float64)
    for sq in chess.SQUARES:
        piece = board.piece_at(sq)
        if piece is None:
            continue
        f, r = chess.square_file(sq), chess.square_rank(sq)
        occ[f, r] = True
        colors[f, r] = WHITE_PIECE if piece.color else BLACK_PIECE
        radii[f, r] = PIECE_RADIUS_FRAC[piece.symbol().lower()]
    return occ, colors, radii


def render_board(occupancy, board_px: int, rng=None, piece_colors=None,
                 piece_radii=None) -> np.ndarray:
    """(board_px, board_px, 3) float64 BGR top-down board from an (8, 8)
    [file, rank] occupancy grid. Rank 8 is the top row. ``piece_colors``
    ((8, 8) of BGR tuples or None) and ``piece_radii`` ((8, 8) disc radius
    fractions, 0 for the default) override the defaults per square."""
    occ = np.asarray(occupancy, bool).reshape(8, 8)
    sq = board_px // 8
    img = np.zeros((board_px, board_px, 3), np.float64)
    for row in range(8):
        for col in range(8):
            img[row * sq : (row + 1) * sq, col * sq : (col + 1) * sq] = (
                LIGHT if (row + col) % 2 == 0 else DARK
            )
    yy, xx = np.mgrid[:sq, :sq]
    d = np.sqrt((yy - sq // 2) ** 2 + (xx - sq // 2) ** 2)
    for f in range(8):
        for rank in range(8):
            if occ[f, rank]:
                frac = PIECE_FRAC
                if piece_radii is not None and piece_radii[f, rank]:
                    frac = float(piece_radii[f, rank])
                color = WHITE_PIECE if rank <= 3 else BLACK_PIECE
                if piece_colors is not None and piece_colors[f, rank] is not None:
                    color = piece_colors[f, rank]
                r = int(sq * frac)
                cell = img[(7 - rank) * sq : (8 - rank) * sq, f * sq : (f + 1) * sq]
                cell[d <= r] = color
                cell[np.abs(d - r) <= 1.0] = OUTLINE
    if rng is not None:
        img = img + rng.normal(0.0, BOARD_NOISE, img.shape)
    return img


class SynthCamera:
    """Renders (H, W, 3) BGR u8 frames of a board seen at ``corners``.

    The frame-to-board sampling map is computed once here; each ``render``
    draws the board and resamples it."""

    def __init__(self, corners, frame_size: Tuple[int, int] = (720, 1280),
                 board_px: int = 800):
        self.frame_size = frame_size
        self.board_px = board_px
        bp = float(board_px)
        src = np.array([[0, 0], [bp, 0], [0, bp], [bp, bp]])
        minv = np.linalg.inv(get_perspective_transform(src, corners))
        h, w = frame_size
        ys, xs = np.mgrid[:h, :w].astype(np.float64)
        den = minv[2, 0] * xs + minv[2, 1] * ys + minv[2, 2]
        bx = (minv[0, 0] * xs + minv[0, 1] * ys + minv[0, 2]) / den
        by = (minv[1, 0] * xs + minv[1, 1] * ys + minv[1, 2]) / den
        inside = (bx >= 0) & (bx < board_px - 1) & (by >= 0) & (by < board_px - 1)
        self._inside = inside
        bx, by = bx[inside], by[inside]
        x0, y0 = np.floor(bx).astype(np.int64), np.floor(by).astype(np.int64)
        self._idx = y0 * board_px + x0
        self._fx = (bx - x0)[:, None]
        self._fy = (by - y0)[:, None]

    def render(self, occupancy, rng=None, piece_colors=None, piece_radii=None) -> np.ndarray:
        board = render_board(occupancy, self.board_px, rng, piece_colors,
                             piece_radii).reshape(-1, 3)
        bp, i, fx, fy = self.board_px, self._idx, self._fx, self._fy
        top = board[i] * (1 - fx) + board[i + 1] * fx
        bot = board[i + bp] * (1 - fx) + board[i + bp + 1] * fx
        frame = np.full(self.frame_size + (3,), float(BACKGROUND))
        frame[self._inside] = top * (1 - fy) + bot * fy
        if rng is not None:
            frame += rng.normal(0.0, FRAME_NOISE, frame.shape)
        return np.clip(frame, 0, 255).astype(np.uint8)


def initial_occupancy() -> np.ndarray:
    """(8, 8) [file, rank] occupancy of the starting position."""
    occ = np.zeros((8, 8), bool)
    occ[:, :2] = True
    occ[:, 6:] = True
    return occ
