# Frozen copy of chessboard_vision_tpu_torch/ops/piece.py at commit 9f9af32, for the
# benchmark's plain reference: imports rewritten to this folder, nothing else
# changed unless a "reference:" comment says so.
"""Batched per-square piece-presence cascade.

Counterpart of chessboard_vision_tpu.ops.piece (reference
piece_detector.py detect_piece :272-345): uniformity prefilter (std < 15),
Hough circle search, center-vs-corner intensity difference (> 40), radial
ring-variance symmetry (> 0.6), for all 64 squares at once; the sequential
cascade becomes masked selects.

Method codes (cascade order preserved): 0 none, 1 hough, 2 tower_top,
3 center_diff, 4 symmetry.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device
from . import hough as hough_ops
from . import hough_conv as hough_conv_ops
from .warp import masked_mean, masked_std

METHOD_NONE, METHOD_HOUGH, METHOD_TOWER_TOP, METHOD_CENTER_DIFF, METHOD_SYMMETRY = range(5)
METHOD_NAMES = [None, "hough", "tower_top", "center_diff", "symmetry"]
STD_THRESHOLD = 15.0  # uniformity prefilter (piece_detector.py)
CIRCLE_THRESHOLD = 0.6  # ring-variance symmetry


class PieceMasks(NamedTuple):
    """Per-square constant masks/denominators for the non-Hough methods."""

    valid: torch.Tensor  # (64, H, W) bool interior mask
    counts: torch.Tensor  # (64,) i32
    center_disk: torch.Tensor  # (64, H, W) bool
    center_counts: torch.Tensor  # (64,) i32
    corners: torch.Tensor  # (64, H, W) bool
    corner_counts: torch.Tensor  # (64,) i32
    rings: torch.Tensor  # (64, 4, H, W) bool
    ring_counts: torch.Tensor  # (64, 4) i32
    heights: torch.Tensor  # (64,) i32
    widths: torch.Tensor  # (64,) i32
    valid_flat: torch.Tensor  # (64, H*W) bool

    @classmethod
    def build(cls, heights, widths, pad_h: int, pad_w: int, device="cuda") -> "PieceMasks":
        """Host-side construction. (pad_h, pad_w) are the tensor dims H, W."""
        device = resolve_device(device, "PieceMasks.build")
        heights = np.asarray(heights, np.int64)
        widths = np.asarray(widths, np.int64)
        H, W = pad_h, pad_w
        yy, xx = np.mgrid[:H, :W]
        valid = np.zeros((64, H, W), bool)
        center = np.zeros((64, H, W), bool)
        corners = np.zeros((64, H, W), bool)
        rings = np.zeros((64, 4, H, W), bool)
        for s in range(64):
            h, w = int(heights[s]), int(widths[s])
            md = min(h, w)
            cy, cx = h // 2, w // 2
            v = (yy < h) & (xx < w)
            valid[s] = v
            radius = md // 4
            center[s] = (((xx - cx) ** 2 + (yy - cy) ** 2) <= radius * radius) & v
            cs = md // 4
            cm = np.zeros((H, W), bool)
            cm[:cs, :cs] = cm[:cs, w - cs : w] = True
            cm[h - cs : h, :cs] = cm[h - cs : h, w - cs : w] = True
            corners[s] = cm & v
            dist = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
            for k, ratio in enumerate((0.15, 0.25, 0.35, 0.45)):
                r = md * ratio
                rings[s, k] = (dist >= r - 5) & (dist <= r + 5) & v

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        return cls(
            valid=t(valid),
            counts=t(valid.sum((1, 2)).astype(np.int32)),
            center_disk=t(center),
            center_counts=t(center.sum((1, 2)).astype(np.int32)),
            corners=t(corners),
            corner_counts=t(corners.sum((1, 2)).astype(np.int32)),
            rings=t(rings),
            ring_counts=t(rings.sum((2, 3)).astype(np.int32)),
            heights=t(heights.astype(np.int32)),
            widths=t(widths.astype(np.int32)),
            valid_flat=t(valid.reshape(64, -1)),
        )


class PieceDetections(NamedTuple):
    has_piece: torch.Tensor  # (64,) bool
    method: torch.Tensor  # (64,) i32 code
    confidence: torch.Tensor  # (64,) f32
    center_x: torch.Tensor  # (64,) f32
    center_y: torch.Tensor  # (64,) f32
    radius: torch.Tensor  # (64,) i32
    std: torch.Tensor  # (64,) f32
    center_border_diff: torch.Tensor  # (64,) f32
    symmetry: torch.Tensor  # (64,) f32
    center_mean: torch.Tensor  # (64,) f32 mean gray over the center disk
    border_mean: torch.Tensor  # (64,) f32 mean gray over the corner patches
    extent: torch.Tensor  # (64,) f32 ring-coverage piece-size profile in
    #   [0, 4] (-1 = low contrast), the piece-type classifier's size feature


def detect_pieces(
    gray: torch.Tensor,
    masks: PieceMasks,
    conv_plan: hough_conv_ops.ConvHoughPlan = None,
    conv_dims: hough_conv_ops.ConvHoughDims = None,
    center_diff_threshold: float = 40.0,
    hough_param1: int = 100,
    hough_param2: int = 25,
    hough_backend: str = "conv",
    hough_params: hough_ops.HoughParams = None,
    hough_bounds: hough_ops.HoughBounds = None,
    std_threshold: float = STD_THRESHOLD,
    circle_threshold: float = CIRCLE_THRESHOLD,
) -> PieceDetections:
    """Raw per-square cascade on preprocessed squares, gray: (64, H, W) u8.

    hough_backend: 'conv' = the annular-correlation detector with the score
    matmul (ops/hough_conv.py, needs conv_plan/conv_dims); 'exact' = the
    cv2-faithful voting transform (ops/hough.py, needs hough_params and
    hough_bounds)."""
    gf = gray.float()

    # Uniformity prefilter: population std over the valid crop.
    std = masked_std(gf, masks.valid, masks.counts)
    std_ok = std >= std_threshold

    # Method 1: Hough circles.
    min_dim = torch.minimum(masks.heights, masks.widths)
    if hough_backend == "conv":
        cc = hough_conv_ops.find_circle(
            gray, conv_plan, conv_dims, param1=hough_param1, param2=hough_param2
        )
        h_found, h_cx, h_cy, h_r = cc.found, cc.cx, cc.cy, cc.radius
        h_small = h_r.float() < min_dim.float() * 0.20
    else:
        circles = hough_ops.hough_circles(
            gray, hough_params, hough_bounds, param1=hough_param1, param2=hough_param2
        )
        h_found, h_cx, h_cy, h_r, h_small = hough_ops.best_circle_near_center(
            circles, masks.heights, masks.widths
        )

    # Method 2: center vs corner-border intensity difference.
    center_mean = masked_mean(gf, masks.center_disk, masks.center_counts)
    border_mean = masked_mean(gf, masks.corners, masks.corner_counts)
    cb_diff = (center_mean - border_mean).abs()
    cb_found = cb_diff > center_diff_threshold

    # Method 3: radial ring-variance symmetry.
    ring_den = masks.ring_counts.float().clamp(min=1.0)
    ring_means = (gf[:, None] * masks.rings).sum(dim=(-2, -1)) / ring_den  # (64, 4)
    rmu = ring_means.mean(dim=-1)
    ring_var = ((ring_means - rmu[:, None]) ** 2).mean(dim=-1)
    symmetry = torch.clamp(ring_var / 500.0, max=1.0)
    sym_found = symmetry > circle_threshold

    # Piece-size profile extent: per ring, the fraction of pixels on the
    # piece's side of the center/border midpoint; -1 on low contrast.
    denom = center_mean - border_mean
    mid = 0.5 * (center_mean + border_mean)
    piece_side = torch.where(
        (denom >= 0.0)[:, None, None],
        gf > mid[:, None, None],
        gf < mid[:, None, None],
    )
    ring_cov = (piece_side[:, None] * masks.rings).sum(dim=(-2, -1)).float() / ring_den
    extent = torch.where(denom.abs() >= 8.0, ring_cov.sum(dim=-1), -1.0)

    # Cascade combine.
    has = std_ok & (h_found | cb_found | sym_found)
    method = torch.where(
        ~std_ok,
        METHOD_NONE,
        torch.where(
            h_found,
            torch.where(h_small, METHOD_TOWER_TOP, METHOD_HOUGH),
            torch.where(
                cb_found, METHOD_CENTER_DIFF,
                torch.where(sym_found, METHOD_SYMMETRY, METHOD_NONE),
            ),
        ),
    ).to(torch.int32)

    conf = torch.where(
        method == METHOD_HOUGH,
        0.9,
        torch.where(
            method == METHOD_TOWER_TOP,
            0.75,
            torch.where(
                method == METHOD_CENTER_DIFF,
                torch.clamp(cb_diff / 80.0, max=1.0),
                torch.where(method == METHOD_SYMMETRY, symmetry, 0.0),
            ),
        ),
    ).float()

    fallback_cx = (masks.widths // 2).float()
    fallback_cy = (masks.heights // 2).float()
    use_hough = (method == METHOD_HOUGH) | (method == METHOD_TOWER_TOP)
    cx = torch.where(use_hough, h_cx, fallback_cx)
    cy = torch.where(use_hough, h_cy, fallback_cy)
    radius = torch.where(use_hough, h_r, min_dim // 3).to(torch.int32)

    return PieceDetections(
        has_piece=has,
        method=method,
        confidence=conf,
        center_x=cx,
        center_y=cy,
        radius=radius,
        std=std,
        center_border_diff=cb_diff,
        symmetry=symmetry,
        center_mean=center_mean,
        border_mean=border_mean,
        extent=extent,
    )
