"""Bilinear resample of a frame at planned coordinates: the padded gray
squares, (64, Qr, Qc), and the warped color board of the enhanced path.

Counterpart of chessboard_vision_tpu.ops.matmul_resample. ``build_plan``
is the JAX package's numpy plan builder, unchanged, so the plans are equal
array for array. ``resample`` computes the same bilinear samples as a
gather of the four taps and a lerp with the plan's ``fx``/``fy`` (the JAX
package's one-hot selection matmuls exist only because TPU XLA serializes
gathers).

Bit-equality of the u8 output with the JAX package on the CPU depends on
the f32 rounding order (ops/xla_rounding.py). XLA:CPU contracts the JAX
form's tap sum ``g = sum_c tap_c * w_c`` (only two weights nonzero) into
one fused multiply-add: when the first nonzero tap sits at band offset 0
its product is the fused one, ``fma(t0, w0, t1*w1)``; otherwise the
second's is, ``fma(t1, w1, t0*w0)``. ``_lerp`` reproduces that,
horizontally with ``ux_off`` and vertically with ``uy_off``.

The u8 resample (``resample_boards_u8``, and ``resample_gray_u8``,
``warp_boards_color`` and ``warp_board_color`` through it) picks by the
frames' device: on the CPU the plain ops (the four taps gathered, the
lerps, the round), on a card one launch of the resample kernel
(kernels/resample.py) for every board and channel, bit-equal to those ops.
Both read the plan's i32 ``src_index``, ``fx``, ``fy`` and one field
``build_plan`` adds beside the JAX package's, ``tap_flags`` (``ux_off ==
0``, ``uy_off == 0`` and ``zero_mask`` in one byte); ``resample`` gives the
plain ops' f32 samples before the round.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from chessboard_vision_tpu_torch.device import resolve_device
from chessboard_vision_tpu_torch.kernels.resample import resample_u8
from chessboard_vision_tpu_torch.ops.xla_rounding import fma

# The bits of ``tap_flags``: which product each lerp fuses, and the 0 sample.
FIRST_X, FIRST_Y, ZERO = 1, 2, 4


def _round_up(x, m):
    return ((x + m - 1) // m) * m


class MatmulResamplePlan(NamedTuple):
    """Per-square sampling constants, on the pipeline's device."""

    row_base: torch.Tensor  # (64, Qr) i32 band start row (region-local)
    col_ix: torch.Tensor  # (64, Qr, Qc) i32 left source col (region-local)
    fx: torch.Tensor  # (64, Qr, Qc) f32
    fy: torch.Tensor  # (64, Qr, Qc) f32
    uy_off: torch.Tensor  # (64, Qr, Qc) i32 floor-row offset within band
    zero_mask: torch.Tensor  # (64, Qr, Qc) bool -> output forced 0
    col_base: torch.Tensor  # (64, Qc) i32 column-band start (region-local)
    ux_off: torch.Tensor  # (64, Qr, Qc) i32 floor-col offset within col band
    src_index: torch.Tensor  # (64, Qr, Qc) i32 flat source index of the
    #   top-left tap (the row/col the JAX form's band selection lands on)
    tap_flags: torch.Tensor  # (64, Qr, Qc) u8 FIRST_X | FIRST_Y | ZERO bits


class MatmulResampleDims(NamedTuple):
    q_rows: int
    q_cols: int
    band: int  # B: band rows per output row (incl. +1 tap)
    region_h: int  # RH
    region_w: int  # RW
    src_h: int
    src_w: int
    ry0: Tuple[int, ...]  # (64,) region row starts
    rx0: Tuple[int, ...]  # (64,) region col starts
    col_band: int = 0  # BC: cols per output col shared across all rows
    # (0 = too wide; the JAX package then takes its per-row path)


def build_plan(qx: np.ndarray, qy: np.ndarray, src_h: int, src_w: int, device="cuda"):
    """qx/qy: (64, Qr, Qc) f32 source coords per padded-square pixel."""
    device = resolve_device(device, "build_plan")
    qx = np.asarray(qx, np.float32)
    qy = np.asarray(qy, np.float32)
    n_sq, Qr, Qc = qx.shape
    ix = np.floor(qx).astype(np.int64)
    iy = np.floor(qy).astype(np.int64)
    fx = (qx - ix).astype(np.float32)
    fy = (qy - iy).astype(np.float32)

    # Out-of-source anchors produce 0 (interior calibrations never hit this).
    bad = (ix < 0) | (ix + 1 >= src_w) | (iy < 0) | (iy + 1 >= src_h)
    big = np.iinfo(np.int64).max

    # Per-square source regions.
    iy_v = np.where(bad, big, iy)
    ix_v = np.where(bad, big, ix)
    ry_min = np.minimum(iy_v.min(axis=(1, 2)), src_h - 2)
    ry_max = np.maximum(np.where(bad, -1, iy).max(axis=(1, 2)) + 1, 1)
    rx_min = np.minimum(ix_v.min(axis=(1, 2)), src_w - 2)
    rx_max = np.maximum(np.where(bad, -1, ix).max(axis=(1, 2)) + 1, 1)
    RH = int(_round_up(int((ry_max - ry_min).max()) + 2, 8))
    RW = int(_round_up(int((rx_max - rx_min).max()) + 2, 8))
    RH = min(RH, src_h)
    RW = min(RW, src_w)
    ry0 = np.clip(ry_min, 0, src_h - RH)
    rx0 = np.clip(rx_min, 0, src_w - RW)

    # Vertical band per (square, out-row), region-local.
    iy_loc = iy - ry0[:, None, None]
    row_min = np.where(bad, big, iy_loc).min(axis=2)
    row_min = np.clip(row_min, 0, RH - 2)
    B = int(np.where(bad, 0, iy_loc - row_min[:, :, None]).max()) + 2
    row_base = np.clip(row_min, 0, RH - B)
    uy_off = np.clip(np.where(bad, 0, iy_loc - row_base[:, :, None]), 0, B - 2)

    ix_loc = np.clip(ix - rx0[:, None, None], 0, RW - 2)
    ix_loc = np.where(bad, 0, ix_loc)

    # Horizontal band per (square, out-column), shared across all rows.
    col_min = np.where(bad, big, ix_loc).min(axis=1)  # (64, Qc)
    col_min = np.clip(col_min, 0, RW - 2)
    BC = int(np.where(bad, 0, ix_loc - col_min[:, None, :]).max()) + 2
    col_base = np.clip(col_min, 0, RW - BC)
    ux_off = np.clip(np.where(bad, 0, ix_loc - col_base[:, None, :]), 0, BC - 2)
    col_band = BC if BC <= 16 else 0

    # Absolute top-left tap: the band row/col the JAX form's selection
    # matmuls pick (per-row path: col_ix directly).
    src_row = ry0[:, None, None] + row_base[:, :, None] + uy_off
    if col_band:
        src_col = rx0[:, None, None] + col_base[:, None, :] + ux_off
    else:
        src_col = rx0[:, None, None] + ix_loc
    src_index = src_row * src_w + src_col
    if src_index.max(initial=0) + src_w + 1 >= 2**31:
        raise ValueError(f"a {src_h}x{src_w} source is too large for the i32 tap index")
    tap_flags = (FIRST_X * (ux_off == 0) + FIRST_Y * (uy_off == 0) + ZERO * bad).astype(np.uint8)

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    plan = MatmulResamplePlan(
        row_base=t(row_base.astype(np.int32)),
        col_ix=t(ix_loc.astype(np.int32)),
        fx=t(fx),
        fy=t(fy),
        uy_off=t(uy_off.astype(np.int32)),
        zero_mask=t(bad),
        col_base=t(col_base.astype(np.int32)),
        ux_off=t(ux_off.astype(np.int32)),
        src_index=t(src_index.astype(np.int32)),
        tap_flags=t(tap_flags),
    )
    dims = MatmulResampleDims(
        q_rows=Qr,
        q_cols=Qc,
        band=B,
        region_h=RH,
        region_w=RW,
        src_h=src_h,
        src_w=src_w,
        ry0=tuple(int(v) for v in ry0),
        rx0=tuple(int(v) for v in rx0),
        col_band=col_band,
    )
    return plan, dims


def _lerp(p0, p1, w0, w1, first_fused):
    """p0*w0 + p1*w1 in XLA:CPU's contraction order (see the module doc)."""
    return torch.where(first_fused, fma(p0, w0, p1 * w1), fma(p1, w1, p0 * w0))


def resample(gray: torch.Tensor, plan: MatmulResamplePlan, dims: MatmulResampleDims):
    """gray: (..., src_h, src_w) u8/f32 -> (..., 64, Qr, Qc) f32 bilinear
    samples of each leading image (a planar frame's 3 channels at once)."""
    lead = tuple(gray.shape[:-2])
    out = _samples(gray.reshape((1, -1) + tuple(gray.shape[-2:])), plan, dims)
    return out.view(lead + tuple(out.shape[-3:]))


def _samples(frames: torch.Tensor, plan: MatmulResamplePlan,
             dims: MatmulResampleDims) -> torch.Tensor:
    """(n, C, Hf, Wf) frames, a plan of n boards (or of one, without the
    board axis) -> (n, C, 64, Qr, Qc) f32 samples: the four taps gathered
    (u8 is exact in f32), then the lerps; 0 where the plan's anchor leaves
    the source."""
    n, c = frames.shape[:2]
    src = frames.reshape(n, c, -1)
    idx = plan.src_index.long().reshape(-1, 1, math.prod(plan.src_index.shape[-3:]))
    shape = (n, c) + tuple(plan.src_index.shape[-3:])

    def tap(offset: int) -> torch.Tensor:
        at = idx if offset == 0 else idx + offset
        return torch.gather(src, 2, at.expand(n, c, -1)).view(shape).float()

    w, fx, fy, flags = dims.src_w, plan.fx, plan.fy, plan.tap_flags
    ox, oy = (flags & FIRST_X) != 0, (flags & FIRST_Y) != 0
    top = _lerp(tap(0), tap(1), 1.0 - fx, fx, ox)
    bot = _lerp(tap(w), tap(w + 1), 1.0 - fx, fx, ox)
    out = _lerp(top, bot, 1.0 - fy, fy, oy)
    return torch.where((flags & ZERO) != 0, 0.0, out)


def use_kernel(frames: torch.Tensor) -> bool:
    """Whether the u8 resample of ``frames`` launches the kernel: off the
    CPU (a tensor the kernel cannot take raises there)."""
    return frames.device.type != "cpu"


def resample_boards_u8(frames: torch.Tensor, plan: MatmulResamplePlan,
                       dims: MatmulResampleDims) -> torch.Tensor:
    """(n, C, Hf, Wf) frames, each board with its own plan (``stack_plans``;
    one plan without a board axis for n = 1) -> (n, C, 64, Qr, Qc) u8
    bilinear samples with the pipeline's round-half-even, clip convention:
    on a card one launch for all boards and channels, else the plain ops."""
    if use_kernel(frames):
        return resample_u8(frames, plan, dims)
    return resample_boards_plain(frames, plan, dims)


def resample_boards_plain(frames: torch.Tensor, plan: MatmulResamplePlan,
                          dims: MatmulResampleDims) -> torch.Tensor:
    """``resample_boards_u8`` in plain ops: ``_samples``, rounded and
    clipped."""
    return torch.round(_samples(frames, plan, dims)).clamp(0, 255).to(torch.uint8)


def resample_gray_u8(gray_frame: torch.Tensor, plan, dims) -> torch.Tensor:
    """(..., src_h, src_w) images, one plan -> (..., 64, Qr, Qc) u8 with the
    pipeline's round-half-even, clip convention (the images as the
    channels of one board)."""
    lead = tuple(gray_frame.shape[:-2])
    out = resample_boards_u8(gray_frame.reshape((1, -1) + tuple(gray_frame.shape[-2:])),
                             plan, dims)
    return out.view(lead + tuple(out.shape[-3:]))


# ---------------------------------------------------------------------------
# Board-level color warp (the with_enhancer path)
# ---------------------------------------------------------------------------


def board_tile_index(starts, tile: int, board_size: int) -> np.ndarray:
    """(B, B) flat index into (64, T, T) tile samples of the tile that owns
    each board pixel: BoardGeometry.board_tile_query_coords's overlapping
    8x8 tiling (tile t = r*8+c covers rows starts[r]:starts[r]+T, columns
    starts[c]:starts[c]+T), where row block r owns rows [r*T, (r+1)*T)
    clipped to B, as in the JAX package's ``assemble_board_from_tiles``."""
    pos = np.arange(board_size)
    block = pos // tile
    local = pos - np.asarray(starts)[block]  # row (or col) inside its tile
    t = block[:, None] * 8 + block[None, :]
    return (t * tile + local[:, None]) * tile + local[None, :]


def stack_plans(plans) -> MatmulResamplePlan:
    """Plans of one shape (rigs of one grid structure and capture size, each
    its own corners) -> one plan with a board axis: every field (n, 1, ...),
    so that it broadcasts over a frame's channels (``warp_boards_color``)."""
    return MatmulResamplePlan(*(torch.stack(field)[:, None] for field in zip(*plans)))


def warp_boards_color(planar_frames: torch.Tensor, plan: MatmulResamplePlan,
                      dims: MatmulResampleDims, index: torch.Tensor) -> torch.Tensor:
    """(n, 3, Hf, Wf) u8 frames and their boards' tile plans stacked
    (``stack_plans``) -> (n, 3, B, B) u8 warped boards, each what
    ``warp_board_color`` gives with its own plan, all boards in one
    ``resample_boards_u8``."""
    return assemble_board_from_tiles(resample_boards_u8(planar_frames, plan, dims), index)


def assemble_board_from_tiles(tiles: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(..., 64, T, T) tiles -> (..., B, B) board by one gather with
    ``board_tile_index``'s index (the JAX package takes 64 static slices
    and 9 concatenates per channel)."""
    return tiles.reshape(*tiles.shape[:-3], -1)[..., index]


def warp_board_color(planar_frame: torch.Tensor, plan: MatmulResamplePlan,
                     dims: MatmulResampleDims, index: torch.Tensor) -> torch.Tensor:
    """(3, Hf, Wf) u8 frame -> (3, B, B) u8 warped board: the tile plan's
    bilinear samples of all three channels (``resample``'s rounding order,
    bit-equal to the JAX package's per tile), rounded, then assembled."""
    tiles = resample_gray_u8(planar_frame, plan, dims)  # (3, 64, T, T)
    return assemble_board_from_tiles(tiles, index)
