"""Synthetic camera frames of a chessboard, rendered in torch on the card.

A copy, rewritten in torch, of chessboard_vision_tpu_torch/tools/synth.py at
commit 9f9af32 (``render_board``, ``SynthCamera``, ``bench_corners``,
``board_render_maps``): a top-down board (light and dark squares, pieces as
filled discs with a dark outline, each piece's true color and a disc radius
by its type) projected into the camera frame at four corners (TL, TR, BL, BR)
by an inverse homography with bilinear sampling, over a flat background,
plus Gaussian sensor noise. Added here: a skin-toned hand, a capsule over a
move's from- and to-squares, drawn on the board before the projection.

Everything is batched: ``Camera.render`` draws K boards of one rig in one
pass. The noise comes from a ``torch.Generator`` on the rendering device, so
the same seed gives the same frames.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .reference import chesslib as chess
from .reference.geometry import get_perspective_transform

LIGHT = (181, 217, 240)
DARK = (99, 136, 181)
WHITE_PIECE = (235, 235, 245)
BLACK_PIECE = (40, 36, 30)
OUTLINE = (20, 20, 20)
SKIN = (105, 160, 215)  # BGR
PIECE_RADIUS_FRAC = {"p": 0.22, "n": 0.27, "b": 0.32, "r": 0.37, "q": 0.43, "k": 0.50}
BOARD_NOISE, FRAME_NOISE = 3.0, 2.0  # Gaussian sigmas (intensity levels)
BACKGROUND = 60
HAND_RADIUS = 0.6  # the hand capsule's half-width, in squares


def bench_corners(height: int, width: int) -> np.ndarray:
    """An axis-aligned board of side min(h, w) - 100 centred in the frame:
    corners TL, TR, BL, BR."""
    bs = min(height, width) - 100
    x0, y0 = (width - bs) // 2, (height - bs) // 2
    return np.array([[x0, y0], [x0 + bs, y0], [x0, y0 + bs], [x0 + bs, y0 + bs]], np.float64)


class Scene:
    """What one frame shows: the rules board's pieces and, during a move, a
    hand over (from square, to square)."""

    def __init__(self, board: "chess.Board", hand: Optional[tuple] = None):
        self.maps = board_render_maps(board)
        self.hand = hand  # ((file, rank), (file, rank)) or None


def board_render_maps(board):
    """(occupancy (8, 8) bool, colors (8, 8, 3), radius fractions (8, 8)),
    indexed [file, rank], of a rules board."""
    occ = np.zeros((8, 8), bool)
    colors = np.zeros((8, 8, 3), np.float64)
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


def render_boards(scenes: Sequence[Scene], board_px: int, device,
                  gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """(K, board_px, board_px, 3) float32 BGR top-down boards. Rank 8 is the
    top row; board pixel (y, x) lies in square (file x // sq, rank 7 - y // sq)."""
    k = len(scenes)
    sq = board_px // 8
    occ = torch.tensor(np.stack([s.maps[0] for s in scenes]), device=device)  # (K, 8, 8)
    col = torch.tensor(np.stack([s.maps[1] for s in scenes]), dtype=torch.float32, device=device)
    rad = torch.tensor(np.stack([s.maps[2] for s in scenes]), dtype=torch.float32, device=device)
    pos = torch.arange(board_px, device=device)
    row, colx = (pos // sq).clamp(max=7), (pos // sq).clamp(max=7)
    file_of, rank_of = colx[None, :], 7 - row[:, None]  # (1, B), (B, 1)
    light = ((row[:, None] + colx[None, :]) % 2 == 0)
    # Pixels past 8 * sq stay black, as synth.py leaves them.
    inside = (pos < 8 * sq)[:, None] & (pos < 8 * sq)[None, :]
    img = torch.where(light[..., None], torch.tensor(LIGHT, dtype=torch.float32, device=device),
                      torch.tensor(DARK, dtype=torch.float32, device=device))
    img = torch.where(inside[..., None], img, 0.0).expand(k, board_px, board_px, 3).clone()
    # Distance of each pixel to its square's centre, inside its own sq x sq cell.
    ly, lx = pos - row * sq, pos - colx * sq
    d = torch.sqrt(((ly - sq // 2)[:, None] ** 2 + (lx - sq // 2)[None, :] ** 2).float())
    f_idx, r_idx = file_of.expand(board_px, board_px), rank_of.expand(board_px, board_px)
    has = occ[:, f_idx, r_idx] & inside  # (K, B, B)
    r = torch.floor(sq * rad[:, f_idx, r_idx])  # int(sq * frac)
    disc = has & (d <= r)
    ring = has & ((d - r).abs() <= 1.0)
    img = torch.where(disc[..., None], col[:, f_idx, r_idx], img)
    img = torch.where(ring[..., None], torch.tensor(OUTLINE, dtype=torch.float32, device=device), img)
    hands = [i for i, s in enumerate(scenes) if s.hand is not None]
    if hands:
        y = (pos.float() + 0.5)[:, None]
        x = (pos.float() + 0.5)[None, :]
        for i in hands:
            (f0, r0), (f1, r1) = scenes[i].hand
            ax, ay = (f0 + 0.5) * sq, (7 - r0 + 0.5) * sq
            bx, by = (f1 + 0.5) * sq, (7 - r1 + 0.5) * sq
            vx, vy = bx - ax, by - ay
            t = (((x - ax) * vx + (y - ay) * vy) / max(vx * vx + vy * vy, 1e-9)).clamp(0, 1)
            dist = torch.sqrt((x - ax - t * vx) ** 2 + (y - ay - t * vy) ** 2)
            img[i] = torch.where((dist <= HAND_RADIUS * sq)[..., None],
                                 torch.tensor(SKIN, dtype=torch.float32, device=device), img[i])
    if gen is not None:
        img = img + BOARD_NOISE * torch.randn(img.shape, generator=gen, device=device)
    return img


class Camera:
    """Renders (H, W, 3) BGR u8 frames of a board seen at ``corners``. The
    frame-to-board sampling map is computed once, here."""

    def __init__(self, corners, frame_size, board_px: int, device):
        self.frame_size = tuple(frame_size)
        self.board_px = board_px
        self.device = torch.device(device)
        bp = float(board_px)
        src = np.array([[0, 0], [bp, 0], [0, bp], [bp, bp]])
        minv = np.linalg.inv(get_perspective_transform(src, np.asarray(corners, np.float64)))
        h, w = self.frame_size
        ys, xs = np.mgrid[:h, :w].astype(np.float64)
        den = minv[2, 0] * xs + minv[2, 1] * ys + minv[2, 2]
        bx = (minv[0, 0] * xs + minv[0, 1] * ys + minv[0, 2]) / den
        by = (minv[1, 0] * xs + minv[1, 1] * ys + minv[1, 2]) / den
        inside = (bx >= 0) & (bx < board_px - 1) & (by >= 0) & (by < board_px - 1)
        x0, y0 = np.floor(bx), np.floor(by)

        def t(a, dtype):
            return torch.as_tensor(a[inside], dtype=dtype, device=self.device)

        self._inside = torch.as_tensor(inside.reshape(-1), device=self.device)
        self._idx = t((y0 * board_px + x0).astype(np.int64), torch.int64)
        self._fx = t(bx - x0, torch.float32)[:, None]
        self._fy = t(by - y0, torch.float32)[:, None]

    def render(self, scenes: Sequence[Scene], gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """(K, H, W, 3) u8 frames on the device, one a scene."""
        boards = render_boards(scenes, self.board_px, self.device, gen).reshape(len(scenes), -1, 3)
        bp, i, fx, fy = self.board_px, self._idx, self._fx, self._fy
        top = boards[:, i] * (1 - fx) + boards[:, i + 1] * fx
        bot = boards[:, i + bp] * (1 - fx) + boards[:, i + bp + 1] * fx
        h, w = self.frame_size
        frame = torch.full((len(scenes), h * w, 3), float(BACKGROUND), device=self.device)
        frame[:, self._inside] = top * (1 - fy) + bot * fy
        if gen is not None:
            frame = frame + FRAME_NOISE * torch.randn(frame.shape, generator=gen, device=self.device)
        return frame.clamp(0, 255).to(torch.uint8).reshape(len(scenes), h, w, 3)
