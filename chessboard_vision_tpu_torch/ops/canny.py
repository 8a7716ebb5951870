"""Canny edge detection, bit-exact vs cv2.Canny (L1 magnitude, aperture 3).

Sobel-3 with replicate border, direction-quantized non-maximum suppression
with OpenCV's exact >/>= tie rules and its tan(22.5) fixed-point constant,
then 8-connected hysteresis written as plain bool ops on (N, H, W).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from chessboard_vision_tpu_torch.ops.filters import sobel3

_TG22 = 13573  # tan(22.5 deg) * 2^15, OpenCV's fixed-point constant
_MAX_ITERS = 256  # dilation cap of the exact fixpoint, as in the JAX package


def _shift2(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift a (..., H, W) tensor by (dy, dx), filling vacated cells with 0."""
    h, w = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0)))
    pb, pr = max(-dy, 0), max(-dx, 0)
    return xp[..., pb : pb + h, pr : pr + w]


def _dilate3(x: torch.Tensor) -> torch.Tensor:
    """8-connected dilation of a (..., H, W) bool map."""
    h, w = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (1, 1, 1, 1))
    v = xp[..., 0:h, :] | xp[..., 1 : h + 1, :] | xp[..., 2 : h + 2, :]
    return v[..., 0:w] | v[..., 1 : w + 1] | v[..., 2 : w + 2]


def canny(img: torch.Tensor, low: int, high: int, hysteresis_rounds: int = -1) -> torch.Tensor:
    """cv2.Canny(img, low, high) for u8 (..., H, W) images -> bool edges.

    hysteresis_rounds: -1 runs the exact fixpoint (bit-exact vs cv2; its
    convergence test reads a flag back to the host once per 4 dilations,
    so it is not for the per-frame path); k >= 0 runs exactly k rounds of
    4 dilations with no host sync (the pipeline's conv Hough path uses 2):
    weak pixels further than 4k steps from a strong pixel are dropped.
    """
    dx, dy = sobel3(img)
    mag = dx.abs() + dy.abs()

    def nb(dy_, dx_):
        return _shift2(mag, -dy_, -dx_)  # value of neighbor at (+dy_, +dx_)

    ax = dx.abs()
    ay = dy.abs() << 15
    tg22x = ax * _TG22
    tg67x = tg22x + (ax << 16)
    horiz = ay < tg22x
    vert = (~horiz) & (ay > tg67x)
    s_pos = (dx ^ dy) >= 0  # gradient signs agree -> main diagonal

    keep_h = (mag > nb(0, -1)) & (mag >= nb(0, 1))
    keep_v = (mag > nb(-1, 0)) & (mag >= nb(1, 0))
    keep_d_pos = (mag > nb(-1, -1)) & (mag > nb(1, 1))
    keep_d_neg = (mag > nb(-1, 1)) & (mag > nb(1, -1))
    keep_d = torch.where(s_pos, keep_d_pos, keep_d_neg)
    keep = torch.where(horiz, keep_h, torch.where(vert, keep_v, keep_d))

    cand = (mag > low) & keep
    strong = cand & (mag > high)
    weak = cand & ~strong

    edges = strong
    if hysteresis_rounds >= 0:
        for _ in range(4 * hysteresis_rounds):
            edges = edges | (_dilate3(edges) & weak)
        return edges

    i = 0
    changed = True
    while changed and i < _MAX_ITERS:
        new = edges
        for _ in range(4):
            new = new | (_dilate3(new) & weak)
        changed = bool((new != edges).any())
        edges = new
        i += 4
    return edges
