"""Synthetic camera frames of a chessboard, rendered with numpy alone.

A top-down board (light/dark squares, pieces as filled discs with a dark
outline, white on ranks 1-4 and black on ranks 5-8 unless per-square colors
are given) is projected into a camera frame at four calibration corners
(TL, TR, BL, BR) by an inverse homography with bilinear sampling, over a
flat background, plus Gaussian sensor noise. Lets the vision path be driven
end to end without a camera. ``board_render_maps`` gives a rules board's
per-square piece colors and per-type disc radii (PIECE_RADIUS_FRAC, the
fractions of tests/fixtures.py), so piece types can be read off the frames.
``draw_circle`` rasterizes a circle inside the image as ``cv2.circle`` does
with its default 8-connected lines, filled or at least 2 px thick, pixel
for pixel.
"""

from __future__ import annotations

import math
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


# cv2.circle's drawing code (OpenCV imgproc/src/drawing.cpp), in Python:
# integer midpoint fills, and a thick outline as cv2 draws it, a polyline
# through the circle's points at a fixed angular step in 16-bit fixed
# point, each segment a filled quadrilateral of the line's width with
# round caps.
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
# cv2's SinTable: sin of each whole degree, 0-450, to 7 decimals, as f32.
_SIN_TABLE = np.float32(np.round(np.sin(np.deg2rad(np.arange(451))), 7)).astype(np.float64)


def _c_div(a: int, b: int) -> int:
    """C's integer division, which truncates toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _fill_circle(img, cx: int, cy: int, radius: int, color) -> None:
    """cv2's filled ``Circle``: horizontal spans from the midpoint walk."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy), (cy + dx, dy)):
            img[y, cx - half:cx + half + 1] = color
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def _line_fixed(img, p1, p2, color) -> None:
    """cv2's ``Line2``: an 8-connected line between fixed-point ends."""
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    along_x = abs(dx) > abs(dy)
    if (dx if along_x else dy) < 0:  # walk from the smaller coordinate
        x1, x2, y1, y2 = x2, x1, y2, y1
        dx, dy = -dx, -dy
    if along_x:
        x_step, y_step = XY_ONE, _c_div(dy << XY_SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> XY_SHIFT
    else:
        x_step, y_step = _c_div(dx << XY_SHIFT, abs(dy) | 1), XY_ONE
        count = (y2 - y1) >> XY_SHIFT
    half = XY_ONE >> 1
    x1, y1 = x1 + half, y1 + half
    img[(y2 + half) >> XY_SHIFT, (x2 + half) >> XY_SHIFT] = color
    if along_x:
        x1 >>= XY_SHIFT
        for _ in range(count + 1):
            img[y1 >> XY_SHIFT, x1] = color
            x1, y1 = x1 + 1, y1 + y_step
    else:
        y1 >>= XY_SHIFT
        for _ in range(count + 1):
            img[y1, x1 >> XY_SHIFT] = color
            x1, y1 = x1 + x_step, y1 + 1


def _fill_convex_poly(img, v, color) -> None:
    """cv2's ``FillConvexPoly`` of fixed-point vertices: the outline's
    lines, then scanlines between a left and a right edge walker."""
    n = len(v)
    half = XY_ONE >> 1
    p0 = v[-1]
    for p in v:
        _line_fixed(img, p0, p, color)
        p0 = p
    ys = [p[1] for p in v]
    imin = ys.index(min(ys))
    y = (min(ys) + half) >> XY_SHIFT
    ymax = (max(ys) + half) >> XY_SHIFT
    edges = n
    # Each walker: [vertex index, index step, x, x step, last y of the edge].
    walkers = [[imin, 1, -XY_ONE, 0, y], [imin, n - 1, -XY_ONE, 0, y]]
    while True:
        for e in walkers:
            if y < e[4]:
                continue
            idx0, di = e[0], e[1]
            idx = (idx0 + di) % n
            while edges > 0:
                edges -= 1
                ty = (v[idx][1] + half) >> XY_SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e[:] = [idx, di, xs, _c_div((xe - xs) * 2 + (ty - y), 2 * (ty - y)), ty]
                    break
                idx0, idx = idx, (idx + di) % n
            else:
                edges -= 1
        if edges < 0:
            break
        left, right = sorted((walkers[0][2], walkers[1][2]))
        img[y, (left + half) >> XY_SHIFT:((right + half) >> XY_SHIFT) + 1] = color
        walkers[0][2] += walkers[0][3]
        walkers[1][2] += walkers[1][3]
        y += 1
        if y > ymax:
            break


def _circle_outline(img, cx: int, cy: int, radius: int, color, thickness: int) -> None:
    """cv2's ``EllipseEx`` of a full circle, ``thickness`` >= 2: its
    polygon (``ellipse2Poly``) drawn as thick line segments."""
    r = radius << XY_SHIFT
    step = (r + (XY_ONE >> 1)) >> XY_SHIFT
    step = 90 if step < 3 else 30 if step < 10 else 18 if step < 15 else 5
    pts = []
    for a in range(0, 360 + step, step):
        a = min(a, 360)
        px = (cx << XY_SHIFT) + float(r) * _SIN_TABLE[450 - a]
        py = (cy << XY_SHIFT) + float(r) * _SIN_TABLE[a]
        qx, qy = int(round(px / XY_ONE)) << XY_SHIFT, int(round(py / XY_ONE)) << XY_SHIFT
        pt = (qx + int(round(px - qx)), qy + int(round(py - qy)))
        if not pts or pt != pts[-1]:
            pts.append(pt)
    if len(pts) == 1:  # a point: one segment of no length, its caps
        pts.append(pts[0])
    width = thickness << (XY_SHIFT - 1)
    odd = thickness & 1
    cap = (width + (XY_ONE >> 1)) >> XY_SHIFT
    for i, (p0, p1) in enumerate(zip(pts, pts[1:])):
        dx, dy = (p0[0] - p1[0]) / XY_ONE, (p1[1] - p0[1]) / XY_ONE
        d2 = dx * dx + dy * dy
        if d2 > np.finfo(np.float64).eps:
            k = (width + odd * XY_ONE * 0.5) / math.sqrt(d2)
            ox, oy = int(round(dy * k)), int(round(dx * k))
            _fill_convex_poly(img, [(p0[0] + ox, p0[1] + oy), (p0[0] - ox, p0[1] - oy),
                                    (p1[0] - ox, p1[1] - oy), (p1[0] + ox, p1[1] + oy)], color)
        # round caps: both ends of the first segment, the far end of the others
        for q in ((p0, p1) if i == 0 else (p1,)):
            _fill_circle(img, (q[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                         (q[1] + (XY_ONE >> 1)) >> XY_SHIFT, cap, color)


def draw_circle(img: np.ndarray, center, radius: int, color, thickness: int) -> None:
    """``cv2.circle(img, center, radius, color, thickness)`` with its
    default line type, in place on an (H, W, C) u8 image: filled for a
    negative ``thickness``, else an outline at least 2 px thick. The
    circle and its outline must lie inside the image (cv2's clipping is
    not reproduced)."""
    cx, cy = (int(c) for c in center)
    reach = int(radius) + max(int(thickness), 0) + 1
    h, w = img.shape[:2]
    if not (reach <= cx < w - reach and reach <= cy < h - reach):
        raise ValueError(f"draw_circle: the circle at {(cx, cy)} of radius {radius} and "
                         f"thickness {thickness} is not inside the {w}x{h} image")
    if thickness < 0:
        _fill_circle(img, cx, cy, int(radius), color)
    elif thickness >= 2:
        _circle_outline(img, cx, cy, int(radius), color, int(thickness))
    else:
        raise ValueError(f"draw_circle: thickness {thickness}: only filled (< 0) or >= 2")
