"""Binding of ``bilateral.cu`` and its plain PyTorch version.

``bilateral_planar`` picks by the tensor's device alone: a CPU tensor takes
the plain version (the CPU tests run it), a CUDA tensor launches the kernel
or raises. ``bilateral_planar.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from chessboard_vision_tpu_torch.kernels import load
from chessboard_vision_tpu_torch.ops.filters import _reflect101_pad

KERNEL_D = 9  # the kernel's disk diameter (radius 4, compiled in)
_lib = None


@functools.lru_cache(maxsize=None)
def space_weights(d: int, sigma_space: float) -> np.ndarray:
    """(d, d) f32 space weights exp(r^2 * -0.5/sigma^2) on the disk of
    radius d//2, exact zeros outside it (the TPU kernel's table). Built
    once per (d, sigma): read-only."""
    r = d // 2
    gs = -0.5 / (sigma_space * sigma_space)
    tab = np.zeros((d, d), np.float32)
    for dy in range(d):
        for dx in range(d):
            r2 = (dy - r) ** 2 + (dx - r) ** 2
            if np.sqrt(r2) <= r:
                tab[dy, dx] = np.exp(r2 * gs)
    tab.flags.writeable = False
    return tab


def bilateral_reference(img: torch.Tensor, d: int = 9, sigma_color: float = 75.0,
                        sigma_space: float = 75.0) -> torch.Tensor:
    """(3, H, W) u8 -> (3, H, W) u8 in the kernel's f32 order: per dy the
    row partials over dx, then added to the running sums."""
    r = d // 2
    gc = float(np.float32(-0.5 / (sigma_color * sigma_color)))
    sw = space_weights(d, sigma_space)
    _, H, W = img.shape
    p = _reflect101_pad(img, r).float()
    center = p[:, r : r + H, r : r + W]
    num = den = 0.0
    for dy in range(d):
        rn = rd = 0.0
        for dx in range(d):
            if sw[dy, dx] == 0.0:
                continue
            nb = p[:, dy : dy + H, dx : dx + W]
            cd = (nb - center).abs().sum(0)
            w = float(sw[dy, dx]) * torch.exp(cd * cd * gc)
            rn = rn + w * nb
            rd = rd + w
        num = num + rn
        den = den + rd
    return torch.round(num / den).clamp(0, 255).to(torch.uint8)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load("bilateral")
        lib.cbv_bilateral.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_float, ctypes.c_void_p,
        ]
        lib.cbv_bilateral.restype = ctypes.c_int
        lib.cbv_cuda_error_string.argtypes = [ctypes.c_int]
        lib.cbv_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def bilateral_planar(img: torch.Tensor, d: int = 9, sigma_color: float = 75.0,
                     sigma_space: float = 75.0) -> torch.Tensor:
    """cv2.bilateralFilter on a planar (3, H, W) u8 image, reflect-101."""
    if img.device.type == "cpu":
        return bilateral_reference(img, d, sigma_color, sigma_space)
    if img.device.type != "cuda":
        raise ValueError(f"bilateral_planar: image on {img.device}, expected CPU or CUDA")
    if img.dtype != torch.uint8 or img.dim() != 3 or img.shape[0] != 3:
        raise ValueError(f"bilateral_planar: expected (3, H, W) uint8, got "
                         f"{tuple(img.shape)} {img.dtype}")
    if d != KERNEL_D:
        raise ValueError(f"bilateral_planar: the kernel is built for d={KERNEL_D}, got {d}")
    _, H, W = img.shape
    if min(H, W) <= d // 2:
        raise ValueError(f"bilateral_planar: image {H}x{W} smaller than the reflect border")
    img = img.contiguous()
    lib = _library()
    sw = space_weights(d, sigma_space)
    gc = float(np.float32(-0.5 / (sigma_color * sigma_color)))
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cbv_bilateral(
            img.data_ptr(), out.data_ptr(), H, W,
            sw.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), gc, stream,
        )
    if rc != 0:
        msg = lib.cbv_cuda_error_string(rc).decode()
        raise RuntimeError(f"bilateral launch failed: {msg} ({rc})")
    bilateral_planar.launches += 1
    return out


bilateral_planar.launches = 0
