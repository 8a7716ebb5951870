"""Otsu thresholding matching cv2.threshold(THRESH_BINARY + THRESH_OTSU).

Counterpart of chessboard_vision_tpu.ops.threshold (reference
prepare_analysis, frame_enhancer.py:148-159): thresholds t = 0..255 are
scanned for the largest between-class variance and the FIRST maximum is
kept; the binary image is (x > t) * 255.
"""

from __future__ import annotations

import torch


def otsu_threshold(x: torch.Tensor) -> torch.Tensor:
    """The Otsu threshold (f32 scalar tensor) of a u8 image."""
    hist = torch.bincount(x.reshape(-1).long(), minlength=256).to(torch.int32)
    # Moments in exact integers: the first moment splits level = 16*q + r
    # so each int32 cumsum stays below 2^31, then recombines in f32.
    levels = torch.arange(256, dtype=torch.int32, device=x.device)
    q1 = torch.cumsum(hist, 0, dtype=torch.int32).float()
    s_hi = torch.cumsum(hist * (levels // 16), 0, dtype=torch.int32).float()
    s_lo = torch.cumsum(hist * (levels % 16), 0, dtype=torch.int32).float()
    s1 = 16.0 * s_hi + s_lo
    n, total = q1[-1], s1[-1]
    q2 = n - q1
    m1 = s1 / q1.clamp(min=1e-38)
    m2 = (total - s1) / q2.clamp(min=1e-38)
    var = q1 * q2 * (m1 - m2) ** 2
    var = torch.where((q1 == 0) | (q2 == 0), -1.0, var)
    return torch.argmax(var).float()  # the first maximum


def otsu_binarize(x: torch.Tensor):
    """(threshold, binary) like cv2.threshold(x, 0, 255, BINARY + OTSU)."""
    t = otsu_threshold(x)
    return t, (x.float() > t).to(torch.uint8) * 255
