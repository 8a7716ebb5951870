"""Gaussian blur and Sobel with OpenCV's u8 integer arithmetic.

The Gaussian is OpenCV's 8-bit fixed-point separable scheme (taps quantized
to 1/256, one combined rounding shift of 16 bits); Sobel-3 works in int32.
Borders are index-based (clamped or reflected indices), which works for
integer tensors on every device.
"""

from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel semantics (float64, normalized).

    For sigma<=0 and ksize in {1,3,5,7,9} OpenCV uses fixed small-kernel
    tables; otherwise sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8.
    """
    small = {
        1: [1.0],
        3: [0.25, 0.5, 0.25],
        5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
        7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
        9: [v / 256.0 for v in (4, 13, 30, 51, 60, 51, 30, 13, 4)],
    }
    if sigma <= 0 and ksize in small:
        return np.array(small[ksize], np.float64)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    i = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-(i**2) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_kernel_u8(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """The 8-bit fixed-point kernel OpenCV's u8 path uses (ints, sum 256)."""
    return np.round(gaussian_kernel(ksize, sigma) * 256).astype(np.int64)


def gaussian_blur_valid(x: torch.Tensor, ksize: int, pad: int = None) -> torch.Tensor:
    """Gaussian blur in 'valid' mode on (..., H, W) u8: the input already
    carries its border (the square resample bakes in a reflect-101 border),
    so the output shrinks by ksize-1. A ``pad`` wider than ksize//2
    center-crops the excess, so the output is always the true crop's size.
    """
    kq = [int(v) for v in gaussian_kernel_u8(ksize)]
    h = x.shape[-2] - (ksize - 1)
    w = x.shape[-1] - (ksize - 1)
    xi = x.to(torch.int32)
    tmp = sum(kq[i] * xi[..., i : i + w] for i in range(ksize))
    out = sum(kq[i] * tmp[..., i : i + h, :] for i in range(ksize))
    out = ((out + (1 << 15)) >> 16).to(torch.uint8)
    if pad is not None:
        off = pad - ksize // 2
        if off < 0:
            raise ValueError(f"pad {pad} too small for kernel {ksize}")
        if off:
            out = out[..., off : out.shape[-2] - off, off : out.shape[-1] - off]
    return out


def _border_index(n: int, border: str, device) -> torch.Tensor:
    """Indices [-1, n] mapped into [0, n) for a 1-pixel border."""
    i = torch.arange(-1, n + 1, device=device)
    if border == "replicate":
        return i.clamp(0, n - 1)
    if border == "reflect101":
        i = i.abs()
        return torch.where(i >= n, 2 * n - 2 - i, i)
    raise ValueError(f"unknown border {border!r}")


def sobel3(x: torch.Tensor, border: str = "replicate"):
    """3x3 Sobel dx, dy on u8 (..., H, W) -> int32 pair.

    border='replicate' matches the Sobel inside cv2.Canny; 'reflect101'
    matches a plain cv2.Sobel call (used by the Hough stage).
    """
    h, w = x.shape[-2], x.shape[-1]
    xi = x.to(torch.int32)
    xp = xi.index_select(-2, _border_index(h, border, x.device))
    xp = xp.index_select(-1, _border_index(w, border, x.device))

    def sl(dy, dx):
        return xp[..., dy : dy + h, dx : dx + w]

    p00, p01, p02 = sl(0, 0), sl(0, 1), sl(0, 2)
    p10, p12 = sl(1, 0), sl(1, 2)
    p20, p21, p22 = sl(2, 0), sl(2, 1), sl(2, 2)
    dx = (p02 + 2 * p12 + p22) - (p00 + 2 * p10 + p20)
    dy = (p20 + 2 * p21 + p22) - (p00 + 2 * p01 + p02)
    return dx, dy
