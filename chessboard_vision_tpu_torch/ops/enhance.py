"""CLAHE and the bilateral filter of the enhancement pipeline.

Counterpart of chessboard_vision_tpu.ops.enhance (reference
frame_enhancer.py:101-181): CLAHE with clip 3.0 and 8x8 tiles on the LAB
L channel, and the bilateral filter d=9, sigma 75/75. Each is the port's
CUDA kernels (kernels/clahe.cu, kernels/bilateral.cu), which compute what
the JAX package's TPU kernels compute; CLAHE's clip, excess redistribution
and CDF over the (tiles^2, 256) histograms run in the histogram kernel's
epilogue, and both CLAHE kernels read the unpadded plane. One kernel covers
each phase for every ``tiles`` and tile size, so the JAX package's choice
between two TPU layouts has no counterpart here.
"""

from __future__ import annotations

import torch

from chessboard_vision_tpu_torch.kernels.bilateral import bilateral_planar  # noqa: F401
from chessboard_vision_tpu_torch.kernels.clahe import (  # noqa: F401
    clahe_apply,
    clahe_hist_luts,
    clahe_luts_from_hist,
)


def clahe(img: torch.Tensor, clip_limit: float = 3.0, tiles: int = 8) -> torch.Tensor:
    """cv2.createCLAHE(clip_limit, (tiles, tiles)).apply for a (H, W) u8
    image: the histograms of its reflect pad to whole tiles with their LUTs
    (one kernel), then the LUT apply (one kernel)."""
    H, W = img.shape
    th, tw = -(-H // tiles), -(-W // tiles)
    area = th * tw
    clip_abs = max(int(clip_limit * area / 256), 1)
    _, luts = clahe_hist_luts(img, th, tw, tiles, clip_abs)
    return clahe_apply(img, luts, th, tw, tiles)
