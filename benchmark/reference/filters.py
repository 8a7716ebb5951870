# Frozen copy of chessboard_vision_tpu_torch/ops/filters.py at commit 9f9af32, for the
# benchmark's plain reference: imports rewritten to this folder, nothing else
# changed unless a "reference:" comment says so.
"""Spatial filters with OpenCV's u8 arithmetic.

Counterpart of chessboard_vision_tpu.ops.filters. The Gaussian is OpenCV's
8-bit fixed-point separable scheme (taps quantized to 1/256, one combined
rounding shift of 16 bits); Sobel-3 and filter2D with an integer kernel
work in int32; min-max normalize in f32. Borders are index-based (clamped
or reflected indices), which works for integer tensors on every device;
BORDER_REFLECT_101 is OpenCV's default.
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


def reflect101(i: torch.Tensor, n: int) -> torch.Tensor:
    """Integer coordinates mapped into [0, n) by reflect-101, reflecting
    again as often as needed (OpenCV's and numpy's "reflect" for a border
    wider than the image)."""
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * n - 2
    j = i.abs() % period
    return torch.where(j >= n, period - j, j)


def _reflect101_index(n: int, r: int, device) -> torch.Tensor:
    """Indices [-r, n + r) mapped into [0, n) by reflect-101."""
    return reflect101(torch.arange(-r, n + r, device=device), n)


def _reflect101_pad(x: torch.Tensor, r: int, axes=(-2, -1)) -> torch.Tensor:
    """Pad ``r`` reflect-101 rows/cols on each side of each of ``axes``."""
    for ax in axes:
        x = x.index_select(ax, _reflect101_index(x.shape[ax], r, x.device))
    return x


def _gauss_u8(x: torch.Tensor, kq) -> torch.Tensor:
    """Separable fixed-point Gaussian over the last two axes of an int32
    tensor that already carries its border."""
    k = len(kq)
    h = x.shape[-2] - (k - 1)
    w = x.shape[-1] - (k - 1)
    tmp = sum(kq[i] * x[..., i : i + w] for i in range(k))
    out = sum(kq[i] * tmp[..., i : i + h, :] for i in range(k))
    return ((out + (1 << 15)) >> 16).to(torch.uint8)


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """Exact cv2.GaussianBlur for u8 single-channel images (..., H, W)."""
    kq = [int(v) for v in gaussian_kernel_u8(ksize, sigma)]
    return _gauss_u8(_reflect101_pad(x.to(torch.int32), ksize // 2), kq)


def gaussian_blur_valid(x: torch.Tensor, ksize: int, sigma: float = 0.0,
                        pad: int = None) -> torch.Tensor:
    """Gaussian blur in 'valid' mode on (..., H, W) u8: the input already
    carries its border (the square resample bakes in a reflect-101 border),
    so the output shrinks by ksize-1. A ``pad`` wider than ksize//2
    center-crops the excess, so the output is always the true crop's size.
    """
    out = _gauss_u8(x.to(torch.int32), [int(v) for v in gaussian_kernel_u8(ksize, sigma)])
    if pad is not None:
        off = pad - ksize // 2
        if off < 0:
            raise ValueError(f"pad {pad} too small for kernel {ksize}")
        if off:
            out = out[..., off : out.shape[-2] - off, off : out.shape[-1] - off]
    return out


def filter2d_int(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Exact cv2.filter2D for u8 images with a small integer kernel.

    ``x`` is (..., H, W) or (..., H, W, C) with C <= 4. Correlation,
    BORDER_REFLECT_101, saturating u8 output."""
    kernel = np.asarray(kernel)
    kh, kw = kernel.shape
    chan = x.dim() >= 3 and x.shape[-1] <= 4
    ay, ax = (-3, -2) if chan else (-2, -1)
    h, w = x.shape[ay], x.shape[ax]
    xp = _reflect101_pad(x.to(torch.int32), kh // 2, axes=(ay,))
    xp = _reflect101_pad(xp, kw // 2, axes=(ax,))
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            c = int(kernel[dy, dx])
            if c == 0:
                continue
            term = c * xp.narrow(ay, dy, h).narrow(ax, dx, w)
            acc = term if acc is None else acc + term
    return acc.clamp(0, 255).to(torch.uint8)


_SHARPEN_KERNEL = np.array([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]])


def sharpen(x: torch.Tensor) -> torch.Tensor:
    """The reference's 3x3 sharpen (frame_enhancer.py:40-42), exact."""
    return filter2d_int(x, _SHARPEN_KERNEL)


def normalize_minmax(x: torch.Tensor, alpha: float = 0.0, beta: float = 255.0) -> torch.Tensor:
    """cv2.normalize(..., NORM_MINMAX) on u8, a joint min/max over all
    pixels of each image: (..., 3, H, W) planar images each on its own (the
    last three axes; a 2-D image is one image), as cv2 normalizes one image
    and the JAX function does under vmap. A constant image gives
    all-``alpha`` (cv2 saturates 0*inf to 0)."""
    xf = x.float()
    dims = tuple(range(-min(x.dim(), 3), 0))
    mn, mx = xf.amin(dims, keepdim=True), xf.amax(dims, keepdim=True)
    scale = (beta - alpha) / torch.clamp(mx - mn, min=1e-38)
    out = torch.where(mx > mn, (xf - mn) * scale + alpha, alpha)
    return torch.round(out).clamp(0, 255).to(torch.uint8)


def _border_index(n: int, border: str, device) -> torch.Tensor:
    """Indices [-1, n] mapped into [0, n) for a 1-pixel border."""
    if border == "replicate":
        return torch.arange(-1, n + 1, device=device).clamp(0, n - 1)
    if border == "reflect101":
        return _reflect101_index(n, 1, device)
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
