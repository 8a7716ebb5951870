# Frozen copy of chessboard_vision_tpu_torch/geometry.py at commit 9f9af32, for the
# benchmark's plain reference: imports rewritten to this folder, nothing else
# changed unless a "reference:" comment says so. reference: the calibration helpers
# (refine_grid, the corner detector, split_board_dict) are left out.
"""Board geometry: corner ordering, homography, warp maps, grid slicing.

Host-side equivalent of reference board_detection.py + grid_extractor.py +
the geometric half of calibration_module.py — except that on TPU the
homography warp and the 8x8 split are not per-frame OpenCV calls but a
single precomputed gather executed on device (see ops/warp.py). Everything
here runs once at calibration time and produces constant index/weight maps.

Coordinate conventions (identical to the reference):
- corners are reordered TL, TR, BL, BR by the sum/diff rule
  (board_detection.py:49-58)
- the warped board is board_size x board_size with
  board_size = min(display_size) - margin = 620 for 1280x720 capture
  (board_detection.py:61-67)
- squares are keyed (file_idx, rank_idx) with a1=(0,0); the top image row
  is rank 8 (grid_extractor.py:8-58)
- device tensors order squares by chess index sq = rank*8 + file (a1=0).

The PyTorch port's own copy of chessboard_vision_tpu/geometry.py, equal to
it function for function. Its two calibration helpers use no OpenCV:
``refine_grid`` and ``find_chessboard_corners`` run their image stages
(gray, Gaussian blur, exact Canny, dilation) as torch ops on ``device``,
each bit-equal to the cv2 call it replaces, and the corner detector's
contour stages in numpy on the host (contours.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch



# ---------------------------------------------------------------------------
# Corner handling
# ---------------------------------------------------------------------------


def reorder(points: np.ndarray) -> np.ndarray:
    """Order 4 corner points TL, TR, BL, BR (reference board_detection.py:49).

    Accepts (4, 2) or (4, 1, 2); returns (4, 1, 2) int32 like the reference.
    """
    pts = np.asarray(points).reshape(4, 2)
    out = np.zeros((4, 1, 2), np.int32)
    s = pts.sum(axis=1)
    d = np.diff(pts, axis=1).ravel()
    out[0] = pts[np.argmin(s)]  # top-left
    out[3] = pts[np.argmax(s)]  # bottom-right
    out[1] = pts[np.argmin(d)]  # top-right
    out[2] = pts[np.argmax(d)]  # bottom-left
    return out


def get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Homography mapping 4 src points to 4 dst points (cv2 equivalent).

    Solves the standard 8x8 linear system in float64.
    """
    src = np.asarray(src, np.float64).reshape(4, 2)
    dst = np.asarray(dst, np.float64).reshape(4, 2)
    A = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        A[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        A[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        b[2 * i] = u
        b[2 * i + 1] = v
    h = np.linalg.solve(A, b)
    return np.append(h, 1.0).reshape(3, 3)


def warp_matrix(
    points: np.ndarray, display_size: Tuple[int, int] = (1280, 720), margin: int = 100
) -> Tuple[np.ndarray, int]:
    """Forward homography + board size (reference warp_image geometry)."""
    board_size = min(display_size) - margin
    pts2 = np.float32(
        [[0, 0], [board_size, 0], [0, board_size], [board_size, board_size]]
    )
    M = get_perspective_transform(np.float32(points).reshape(4, 2), pts2)
    return M, board_size


def inverse_coord_maps(
    M: np.ndarray, out_h: int, out_w: int, flip180: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Source-coordinate maps (X, Y) float32 for the inverse warp.

    Matches OpenCV 5's warpPerspective coordinate math (per-pixel float
    division). When ``flip180`` the output is the 180deg-rotated board (the
    reference rotates the warped image when playing as black,
    game_session.py:125-126) — baked in by flipping the destination grid.
    """
    Minv = np.linalg.inv(M)
    xs, ys = np.meshgrid(np.arange(out_w, dtype=np.float64), np.arange(out_h, dtype=np.float64))
    if flip180:
        xs = (out_w - 1) - xs
        ys = (out_h - 1) - ys
    den = Minv[2, 0] * xs + Minv[2, 1] * ys + Minv[2, 2]
    X = (Minv[0, 0] * xs + Minv[0, 1] * ys + Minv[0, 2]) / den
    Y = (Minv[1, 0] * xs + Minv[1, 1] * ys + Minv[1, 2]) / den
    return X.astype(np.float32), Y.astype(np.float32)


def crop_inner_squares(img_warped: np.ndarray, board_size: int, offset: int = 0):
    """Crop a margin off the warped board (reference board_detection.py:74)."""
    cropped = img_warped[offset : board_size - offset, offset : board_size - offset]
    return cropped, board_size - 2 * offset


# ---------------------------------------------------------------------------
# Grid lines
# ---------------------------------------------------------------------------


def linear_grid_lines(board_size: int) -> List[int]:
    """The implicit 9 grid lines of the linear splitter.

    Reference GridExtractor.split_board uses square = board_size // 8 and
    drops the remainder (grid_extractor.py:33-46): squares span
    [i*sq, (i+1)*sq), so the effective lines are multiples of sq.
    """
    sq = board_size // 8
    return [i * sq for i in range(9)]


def refine_grid_lines(edges_row_proj: np.ndarray, length: int, count: int = 7) -> List[int]:
    """Peak search for internal grid lines (reference grid_extractor.py:89-112).

    ``edges_row_proj`` is the 1-D projection (sum of edge map along the
    perpendicular axis). Searches a +-30% window around each expected line.
    """
    expected_step = length / 8.0
    lines = [0]
    for i in range(1, 8):
        center = int(i * expected_step)
        radius = int(expected_step * 0.3)
        lo = max(0, center - radius)
        hi = min(length, center + radius)
        window = edges_row_proj[lo:hi]
        lines.append(lo + int(np.argmax(window)) if len(window) else center)
    lines.append(length)
    return lines


@dataclass
class SquareMaps:
    """Constant gather maps turning a warped board into a (64, H, W) tensor.

    Square order is chess index sq = rank*8 + file (a1=0 .. h8=63). ``pad``
    rows/cols of reflect-101 border are baked into the indices so that a
    subsequent valid-mode blur reproduces per-crop OpenCV border behavior
    exactly. Invalid (beyond the square's true size) positions clamp to the
    square's edge and are masked out of reductions via ``mask``/``counts``.
    """

    iy: np.ndarray  # (64, H+2p, W+2p) int32 row index into the board image
    ix: np.ndarray  # (64, H+2p, W+2p) int32 col index
    mask: np.ndarray  # (64, H, W) bool, valid interior positions
    heights: np.ndarray  # (64,) int32 true crop heights
    widths: np.ndarray  # (64,) int32
    pad: int
    square_h: int  # H (max height)
    square_w: int  # W

    @property
    def counts(self) -> np.ndarray:
        return (self.heights * self.widths).astype(np.int32)


def _reflect101_idx(i: np.ndarray, n: int) -> np.ndarray:
    """Reflect-101 index into [0, n) for |i| within one period (small pads)."""
    i = np.abs(i)
    i = np.where(i >= n, np.maximum(2 * n - 2 - i, 0), i)
    return i


def build_square_maps(
    grid_x: Sequence[int], grid_y: Sequence[int], pad: int = 0
) -> SquareMaps:
    """Build gather maps from 9+9 grid-line coordinates.

    Reference split semantics (grid_extractor.py:123-163): square at visual
    (row r, col c) spans [y[r], y[r+1]) x [x[c], x[c+1]) and maps to logical
    (file=c, rank=7-r).
    """
    grid_x = list(map(int, grid_x))
    grid_y = list(map(int, grid_y))
    ws = np.array([grid_x[c + 1] - grid_x[c] for c in range(8)], np.int32)
    hs = np.array([grid_y[r + 1] - grid_y[r] for r in range(8)], np.int32)
    W = int(ws.max())
    H = int(hs.max())
    Hp, Wp = H + 2 * pad, W + 2 * pad

    iy = np.zeros((64, Hp, Wp), np.int32)
    ix = np.zeros((64, Hp, Wp), np.int32)
    mask = np.zeros((64, H, W), bool)
    heights = np.zeros(64, np.int32)
    widths = np.zeros(64, np.int32)

    jy = np.arange(Hp) - pad  # local row coords incl. border
    jx = np.arange(Wp) - pad

    for r in range(8):
        for c in range(8):
            sq = (7 - r) * 8 + c  # rank*8 + file
            h, w = int(hs[r]), int(ws[c])
            heights[sq], widths[sq] = h, w
            # Reflect-101 both borders into the true crop; positions past the
            # square's own reflected border (padding for smaller squares) are
            # clamped — they fall outside `mask` and never reach a reduction.
            ly = np.clip(_reflect101_idx(jy, h), 0, h - 1)
            lx = np.clip(_reflect101_idx(jx, w), 0, w - 1)
            iy[sq] = (grid_y[r] + ly)[:, None]
            ix[sq] = (grid_x[c] + lx)[None, :]
            mask[sq, :h, :w] = True

    return SquareMaps(
        iy=iy, ix=ix, mask=mask, heights=heights, widths=widths,
        pad=pad, square_h=H, square_w=W,
    )


# ---------------------------------------------------------------------------
# Full calibration geometry
# ---------------------------------------------------------------------------


@dataclass
class BoardGeometry:
    """Everything the device pipeline needs, precomputed from calibration.

    Produced once from the calibration config (corners + optional smart-grid
    lines + orientation); consumed by ops/warp.py device functions.
    """

    matrix: np.ndarray  # forward homography (3,3) f64
    board_size: int
    orientation_flipped: bool
    grid_x: List[int]
    grid_y: List[int]
    warp_X: np.ndarray = field(repr=False)  # (B,B) f32 source x coords
    warp_Y: np.ndarray = field(repr=False)
    squares: SquareMaps = field(repr=False)
    src_w: int = 1280  # camera frame width
    src_h: int = 720
    # Calibration corners (TL, TR, BL, BR) this geometry was built from;
    # kept so sessions can rebuild a shifted geometry (auto-recalibration,
    # session/drift.py) without re-threading the calibration config.
    src_corners: Optional[np.ndarray] = None

    def square_query_coords(self):
        """Source-frame coords for every padded square pixel: the composed
        warp+extract sampling positions, (64, Hp, Wp) each for X and Y."""
        qx = self.warp_X[self.squares.iy, self.squares.ix]
        qy = self.warp_Y[self.squares.iy, self.squares.ix]
        return qx, qy

    def board_tile_query_coords(self):
        """Source-frame coords for the warped board as 64 overlapping tiles.

        The full (B, B) board warp can't ride the matmul resampler in one
        piece (the per-output-row column-weight tensor would be O(B^2 * W)),
        so the board is tiled 8x8 with tile size T = ceil(B / 8); the last
        row/column of tiles overlaps its neighbor so T*8 >= B without
        sampling outside the board. Returns (qx, qy, starts, T): qx/qy are
        (64, T, T) source coords (tile t = r*8+c covers board rows
        starts[r]:starts[r]+T, cols starts[c]:starts[c]+T);
        ``assemble_board_from_tiles`` inverts the tiling.
        """
        B = self.board_size
        T = -(-B // 8)
        starts = tuple(min(i * T, B - T) for i in range(8))
        qx = np.empty((64, T, T), np.float32)
        qy = np.empty((64, T, T), np.float32)
        for r in range(8):
            for c in range(8):
                sr, sc = starts[r], starts[c]
                qx[r * 8 + c] = self.warp_X[sr : sr + T, sc : sc + T]
                qy[r * 8 + c] = self.warp_Y[sr : sr + T, sc : sc + T]
        return qx, qy, starts, T

    @classmethod
    def from_calibration(
        cls,
        corners,
        display_size: Tuple[int, int] = (1280, 720),
        margin: int = 100,
        orientation_flipped: bool = False,
        grid_lines_x: Optional[Sequence[int]] = None,
        grid_lines_y: Optional[Sequence[int]] = None,
        blur_pad: int = 2,
    ) -> "BoardGeometry":
        pts = reorder(corners)
        M, bs = warp_matrix(pts, display_size, margin)
        X, Y = inverse_coord_maps(M, bs, bs, flip180=orientation_flipped)
        gx = list(grid_lines_x) if grid_lines_x is not None and len(grid_lines_x) else linear_grid_lines(bs)
        gy = list(grid_lines_y) if grid_lines_y is not None and len(grid_lines_y) else linear_grid_lines(bs)
        sq = build_square_maps(gx, gy, pad=blur_pad)
        return cls(
            matrix=M,
            board_size=bs,
            orientation_flipped=orientation_flipped,
            grid_x=gx,
            grid_y=gy,
            warp_X=X,
            warp_Y=Y,
            squares=sq,
            src_w=display_size[0],
            src_h=display_size[1],
            src_corners=np.asarray(pts).reshape(4, 2).astype(np.float64),
        )

    def with_corners(self, corners) -> "BoardGeometry":
        """Rebuild this geometry around shifted calibration corners,
        keeping display size, orientation, smart-grid lines, and blur pad
        (auto-recalibration path — the grid structure is unchanged, so
        resample-plan static dims and compiled programs stay valid)."""
        g = type(self).from_calibration(
            corners,
            display_size=(self.src_w, self.src_h),
            orientation_flipped=self.orientation_flipped,
            grid_lines_x=self.grid_x,
            grid_lines_y=self.grid_y,
            blur_pad=self.squares.pad,
        )
        assert g.board_size == self.board_size, "grid structure must be preserved"
        return g

    @classmethod
    def from_config(cls, config: dict, **kw) -> "BoardGeometry":
        """Build from a calibration.json-style dict (reference format).

        An optional "display_size": [w, h] key overrides the reference's
        fixed 1280x720 capture assumption (play_lichess.py:11) for rigs
        calibrated at other resolutions."""
        if "display_size" in config and "display_size" not in kw:
            kw["display_size"] = tuple(config["display_size"])
        return cls.from_calibration(
            np.array(config["corners"]),
            orientation_flipped=config.get("orientation_flipped", False),
            grid_lines_x=config.get("grid_lines_x"),
            grid_lines_y=config.get("grid_lines_y"),
            **kw,
        )
