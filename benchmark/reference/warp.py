# Frozen copy of chessboard_vision_tpu_torch/ops/warp.py at commit 9f9af32, for the
# benchmark's plain reference: imports rewritten to this folder, nothing else
# changed unless a "reference:" comment says so.
"""Perspective warp by gather, square extraction, board-geometry constants
on the device and masked per-square reductions.

Counterpart of chessboard_vision_tpu.ops.warp. HWC frames take this warp
(models/pipeline.py says which): each board pixel reads its four source
pixels at the calibration-time maps ``warp_X``/``warp_Y`` (constant 0
outside the frame, OpenCV's border), blends them bilinearly and rounds
half to even; the squares (with their reflect-101 blur border baked into
``sq_iy``/``sq_ix``) are then gathered from the board. The lerps round as
the jitted JAX function does: XLA:CPU contracts each ``a + f*(b - a)`` into
one fused multiply-add, so the u8 board is bit-equal to the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .device import resolve_device
from .geometry import BoardGeometry
from .xla_rounding import fma


class DeviceGeometry(NamedTuple):
    """BoardGeometry constants as device tensors."""

    warp_X: torch.Tensor  # (B, B) f32 source x of each board pixel
    warp_Y: torch.Tensor  # (B, B) f32 source y
    sq_iy: torch.Tensor  # (64, Hp, Wp) i32 board row of each padded square pixel
    sq_ix: torch.Tensor  # (64, Hp, Wp) i32 board column
    sq_mask: torch.Tensor  # (64, H, W) bool valid interior pixels
    sq_mask_flat: torch.Tensor  # (64, H*W) bool the same, flat (the change model's layout)
    sq_counts: torch.Tensor  # (64,) i32 true pixel counts per square
    sq_heights: torch.Tensor  # (64,) i32
    sq_widths: torch.Tensor  # (64,) i32

    @property
    def pad(self) -> int:
        """The squares' blur border: (Hp - H) // 2."""
        return (self.sq_iy.shape[1] - self.sq_mask.shape[1]) // 2

    @classmethod
    def from_host(cls, geom: BoardGeometry, device="cuda") -> "DeviceGeometry":
        device = resolve_device(device, "DeviceGeometry.from_host")
        s = geom.squares

        def t(a, dtype=None):
            return torch.as_tensor(a, dtype=dtype, device=device)

        return cls(
            warp_X=t(geom.warp_X, torch.float32),
            warp_Y=t(geom.warp_Y, torch.float32),
            sq_iy=t(s.iy, torch.int32),
            sq_ix=t(s.ix, torch.int32),
            sq_mask=t(s.mask),
            sq_mask_flat=t(s.mask.reshape(s.mask.shape[0], -1)),
            sq_counts=t(s.counts),
            sq_heights=t(s.heights),
            sq_widths=t(s.widths),
        )


def warp_bilinear(img: torch.Tensor, X: torch.Tensor, Y: torch.Tensor,
                  contract: bool = True) -> torch.Tensor:
    """Inverse-map bilinear warp with a constant-0 border (cv2 semantics).

    img: (..., H, W, C) u8 with any leading axes. X, Y: (outH, outW) f32
    source coordinates. Returns (..., outH, outW, C) u8. ``contract``
    rounds the three lerps as the JAX warp inside a jitted step
    (XLA:CPU's fused multiply-adds); without it each product and sum is
    rounded to f32, as the JAX warp run op by op (its ``warp_board``)."""
    H, W = img.shape[-3], img.shape[-2]
    flat = img.reshape(img.shape[:-3] + (H * W, img.shape[-1]))
    ixf, iyf = torch.floor(X), torch.floor(Y)
    # The fractions are exact in f32; the taps and their differences are
    # integers, exact in float64, where each fused multiply-add is rounded
    # once to f32 (xla_rounding.fma's arithmetic, with fewer conversions).
    fx = (X - ixf)[..., None].double()
    fy = (Y - iyf)[..., None].double()
    ix, iy = ixf.to(torch.int64), iyf.to(torch.int64)

    def tap(dy, dx):
        yy, xx = iy + dy, ix + dx
        inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(-1)
        v = flat.index_select(-2, idx).reshape(img.shape[:-3] + X.shape + (img.shape[-1],))
        return v.double() * inb[..., None]

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    if contract:
        top = torch.addcmul(p00, fx, p01 - p00).float()
        bot = torch.addcmul(p10, fx, p11 - p10).float()
        val = fma(fy, bot - top, top)
    else:  # integer taps and exact fractions: f32 arithmetic, op by op
        p00, p01, p10, p11, fx, fy = (t.float() for t in (p00, p01, p10, p11, fx, fy))
        top = p00 + fx * (p01 - p00)
        bot = p10 + fx * (p11 - p10)
        val = top + fy * (bot - top)
    return torch.round(val).clamp(0, 255).to(torch.uint8)


def extract_squares(board: torch.Tensor, g: DeviceGeometry) -> torch.Tensor:
    """(..., B, B, C) color board -> (..., 64, Hp, Wp, C) padded squares, a1
    = index 0 (reference split_board semantics, grid_extractor.py:123-163)."""
    B, C = board.shape[-2], board.shape[-1]
    flat = board.reshape(board.shape[:-3] + (B * B, C))
    out = flat.index_select(-2, (g.sq_iy * B + g.sq_ix).reshape(-1))
    return out.reshape(board.shape[:-3] + tuple(g.sq_iy.shape) + (C,))


def extract_gray_squares(board: torch.Tensor, g: DeviceGeometry) -> torch.Tensor:
    """(..., B, B) gray board -> (..., 64, Hp, Wp) padded squares, as
    ``extract_squares``."""
    B = board.shape[-1]
    flat = board.reshape(board.shape[:-2] + (B * B,))
    out = flat.index_select(-1, (g.sq_iy * B + g.sq_ix).reshape(-1))
    return out.reshape(board.shape[:-2] + tuple(g.sq_iy.shape))


def frame_to_board(frame: torch.Tensor, g: DeviceGeometry,
                   contract: bool = True) -> torch.Tensor:
    """(..., Hf, Wf, 3) camera frame -> (..., B, B, 3) top-down board
    (orientation flip baked into the maps); ``contract`` as warp_bilinear."""
    return warp_bilinear(frame, g.warp_X, g.warp_Y, contract)


def frame_to_squares(frame: torch.Tensor, g: DeviceGeometry) -> torch.Tensor:
    """(..., Hf, Wf, 3) frame -> board -> (..., 64, Hp, Wp, 3) squares."""
    return extract_squares(frame_to_board(frame, g), g)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Mean over each square's valid region. x: (64, H, W) -> (64,) f32.

    The f32 sum is exact for u8 inputs (integers below 2^24), so the result
    does not depend on the summation order."""
    s = (x.float() * mask).sum(dim=(-2, -1))
    return s / counts.float()


def masked_std(x: torch.Tensor, mask: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Population std over each square's valid region (np.std semantics).
    x: (64, H, W) -> (64,) f32."""
    xf = x.float()
    n = counts.float()
    mu = (xf * mask).sum(dim=(-2, -1)) / n
    d2 = torch.where(mask, (xf - mu[:, None, None]) ** 2, 0.0)
    return torch.sqrt(d2.sum(dim=(-2, -1)) / n)


def interior(x: torch.Tensor, g: DeviceGeometry) -> torch.Tensor:
    """Strip the blur border: (64, Hp, Wp[, C]) -> (64, H, W[, C])."""
    p = g.pad
    H, W = g.sq_mask.shape[1], g.sq_mask.shape[2]
    return x[:, p : p + H, p : p + W]
