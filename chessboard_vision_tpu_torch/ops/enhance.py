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

Backends (``clahe(backend=)``, ``models/enhancer.bilateral(backend=)``):
"auto" runs the kernels on a CUDA tensor and their plain torch versions on
a CPU tensor; "kernel" always runs the kernels and raises for a tensor
that is not on a card; "plain" runs the plain versions on either device.
A shape a kernel does not take raises under "auto" and "kernel": the plain
version runs only where the caller names it.
"""

from __future__ import annotations

import torch

from chessboard_vision_tpu_torch.kernels.bilateral import (  # noqa: F401
    bilateral_planar,
    bilateral_reference,
)
from chessboard_vision_tpu_torch.kernels.clahe import (  # noqa: F401
    clahe_apply,
    clahe_apply_reference,
    clahe_hist_luts,
    clahe_hist_luts_reference,
    clahe_luts_from_hist,
)

BACKENDS = ("auto", "kernel", "plain")


def use_kernel(t: torch.Tensor, backend: str, what: str) -> bool:
    """Whether ``what`` launches its kernel on ``t`` under ``backend``
    (module docstring); raises for "kernel" off a card and for an unknown
    backend."""
    if backend == "plain":
        return False
    if backend == "auto":
        return t.device.type != "cpu"
    if backend == "kernel":
        if t.device.type != "cuda":
            raise ValueError(f"{what}: backend='kernel' runs the CUDA kernel, and this tensor "
                             f"is on {t.device}; use 'plain' or 'auto' there")
        return True
    raise ValueError(f"unknown {what} backend {backend!r}: use one of {BACKENDS}")


def clahe(img: torch.Tensor, clip_limit: float = 3.0, tiles: int = 8,
          backend: str = "auto") -> torch.Tensor:
    """cv2.createCLAHE(clip_limit, (tiles, tiles)).apply for (..., H, W) u8
    images, each on its own: the histograms of their reflect pad to whole
    tiles with their LUTs (one kernel for all images), then the LUT apply
    (one kernel); ``backend`` as in the module docstring."""
    H, W = img.shape[-2:]
    th, tw = -(-H // tiles), -(-W // tiles)
    area = th * tw
    clip_abs = max(int(clip_limit * area / 256), 1)
    if not use_kernel(img, backend, "clahe"):
        _, luts = clahe_hist_luts_reference(img, th, tw, tiles, clip_abs)
        return clahe_apply_reference(img, luts, th, tw, tiles)
    _, luts = clahe_hist_luts(img, th, tw, tiles, clip_abs)
    return clahe_apply(img, luts, th, tw, tiles)
