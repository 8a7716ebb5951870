"""CLAHE and the bilateral filter of the enhancement pipeline.

Counterpart of chessboard_vision_tpu.ops.enhance (reference
frame_enhancer.py:101-181): CLAHE with clip 3.0 and 8x8 tiles on the LAB
L channel, and the bilateral filter d=9, sigma 75/75. The per-pixel phases
are the port's CUDA kernels (kernels/clahe.cu, kernels/bilateral.cu), which
compute what the JAX package's TPU kernels compute; the clip, excess
redistribution and CDF over the (tiles^2, 256) histograms are torch ops.
One kernel covers each phase for every ``tiles`` and tile size, so the JAX
package's choice between two TPU layouts has no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from chessboard_vision_tpu_torch.kernels.bilateral import bilateral_planar  # noqa: F401
from chessboard_vision_tpu_torch.kernels.clahe import clahe_apply, clahe_hist


def clahe_luts_from_hist(hist: torch.Tensor, area: int, clip_abs: int) -> torch.Tensor:
    """(n_tiles, 256) i32 histograms -> (n_tiles, 256) f32 integer-valued
    LUTs: clip, OpenCV's two-phase excess redistribution, scaled CDF."""
    excess = (hist - clip_abs).clamp(min=0).sum(-1, dtype=torch.int32)
    hist = hist.clamp(max=clip_abs)
    batch = excess // 256
    resid = excess - batch * 256
    hist = hist + batch[:, None]
    step = (256 // resid.clamp(min=1)).clamp(min=1)
    bins = torch.arange(256, dtype=torch.int32, device=hist.device)
    bump = ((bins % step[:, None]) == 0) & ((bins // step[:, None]) < resid[:, None])
    cdf = torch.cumsum(hist + bump.to(torch.int32), -1, dtype=torch.int32)
    scale = float(np.float32(255.0 / area))
    return torch.round(cdf.float() * scale).clamp(0, 255)


def _reflect_pad_end(img: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """Reflect-101 rows/cols onto the bottom and right, to (hp, wp)."""
    for ax, n in ((0, hp), (1, wp)):
        size = img.shape[ax]
        if n > size:
            i = torch.arange(n, device=img.device)
            img = img.index_select(ax, torch.where(i >= size, 2 * size - 2 - i, i))
    return img


def clahe(img: torch.Tensor, clip_limit: float = 3.0, tiles: int = 8) -> torch.Tensor:
    """cv2.createCLAHE(clip_limit, (tiles, tiles)).apply for a (H, W) u8
    image: reflect-pad to whole tiles, histogram kernel, LUTs, apply
    kernel, crop."""
    H, W = img.shape
    th, tw = -(-H // tiles), -(-W // tiles)
    pad = _reflect_pad_end(img, th * tiles, tw * tiles)
    area = th * tw
    clip_abs = max(int(clip_limit * area / 256), 1)
    luts = clahe_luts_from_hist(clahe_hist(pad, th, tw, tiles), area, clip_abs)
    return clahe_apply(pad, luts, th, tw, tiles)[:H, :W]
