"""Binding of ``clahe.cu`` (histogram and LUT apply) and plain versions.

Both wrappers pick by the tensors' device alone: CPU tensors take the plain
version (the CPU tests run it), CUDA tensors launch the kernel or raise.
``clahe_hist.launches`` and ``clahe_apply.launches`` count kernel launches.
The input is the reflect-padded image, (th * tiles, tw * tiles) u8.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from chessboard_vision_tpu_torch.kernels import load
from chessboard_vision_tpu_torch.ops.xla_rounding import fma

_lib = None


def _check_padded(img: torch.Tensor, th: int, tw: int, tiles: int, what: str) -> None:
    if img.dtype != torch.uint8 or img.dim() != 2:
        raise ValueError(f"{what}: expected a 2-D uint8 image, got {tuple(img.shape)} {img.dtype}")
    if tuple(img.shape) != (th * tiles, tw * tiles):
        raise ValueError(f"{what}: image {tuple(img.shape)} is not {tiles}x{tiles} tiles "
                         f"of {th}x{tw}")


def clahe_hist_reference(img: torch.Tensor, th: int, tw: int, tiles: int) -> torch.Tensor:
    """(tiles^2, 256) i32 per-tile histograms by one bincount over
    tile * 256 + value keys."""
    Hp, Wp = img.shape
    ty = torch.arange(Hp, device=img.device) // th
    tx = torch.arange(Wp, device=img.device) // tw
    keys = (ty[:, None] * tiles + tx[None, :]) * 256 + img.long()
    n = tiles * tiles
    return torch.bincount(keys.reshape(-1), minlength=n * 256).reshape(n, 256).to(torch.int32)


def _inv(size: int) -> float:
    """1/size rounded to f32: XLA turns the TPU kernel's divide by the
    constant tile size into a multiply by this reciprocal."""
    return float(np.float32(1.0) / np.float32(size))


def _tile_coords(n: int, size: int, tiles: int, device):
    """Per row (or column) p: the clipped tile pair (i0, i1) and the f32
    fraction of fma(p, 1/size, -0.5), as the TPU kernel computes them."""
    tf = fma(torch.arange(n, device=device, dtype=torch.float32), _inv(size),
             torch.full((n,), -0.5, device=device))
    t0 = torch.floor(tf)
    i0 = t0.to(torch.int64)
    return i0.clamp(0, tiles - 1), (i0 + 1).clamp(0, tiles - 1), tf - t0


def clahe_apply_reference(img: torch.Tensor, luts: torch.Tensor, th: int, tw: int,
                          tiles: int) -> torch.Tensor:
    """Bilinear mix of the 4 neighbour-tile LUTs with the kernel's f32
    operations: ey = fma(1 - fy, e0, fy * e1) per tile column, then
    fma(fx, ey1, (1 - fx) * ey0) (clahe.cu says why)."""
    Hp, Wp = img.shape
    y0, y1, fy = (a[:, None] for a in _tile_coords(Hp, th, tiles, img.device))
    x0, x1, fx = (a[None, :] for a in _tile_coords(Wp, tw, tiles, img.device))
    flat = luts.reshape(-1)
    v = img.long()

    def e(ty, tx):
        return flat[(ty * tiles + tx) * 256 + v]

    gy0, gx0 = 1.0 - fy, 1.0 - fx
    ey0 = fma(e(y0, x0), gy0, fy * e(y1, x0))
    ey1 = fma(e(y0, x1), gy0, fy * e(y1, x1))
    res = torch.where(x0 == x1, (gx0 + fx) * ey0, fma(ey1, fx, gx0 * ey0))
    return torch.round(res).clamp(0, 255).to(torch.uint8)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load("clahe")
        lib.cbv_clahe_hist.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.cbv_clahe_hist.restype = ctypes.c_int
        lib.cbv_clahe_apply.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.cbv_clahe_apply.restype = ctypes.c_int
        lib.cbv_cuda_error_string.argtypes = [ctypes.c_int]
        lib.cbv_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_if(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.cbv_cuda_error_string(rc).decode()} ({rc})")


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {t.device}, expected CPU or CUDA")


def clahe_hist(img: torch.Tensor, th: int, tw: int, tiles: int) -> torch.Tensor:
    """Per-tile 256-bin histograms of a padded (th*tiles, tw*tiles) u8
    image -> (tiles^2, 256) i32."""
    if img.device.type == "cpu":
        return clahe_hist_reference(img, th, tw, tiles)
    _require_cuda(img, "clahe_hist")
    _check_padded(img, th, tw, tiles, "clahe_hist")
    img = img.contiguous()
    lib = _library()
    hist = torch.empty((tiles * tiles, 256), dtype=torch.int32, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cbv_clahe_hist(img.data_ptr(), hist.data_ptr(), img.shape[1], th, tw, tiles,
                                stream)
    _raise_if(rc, lib, "clahe_hist")
    clahe_hist.launches += 1
    return hist


def clahe_apply(img: torch.Tensor, luts: torch.Tensor, th: int, tw: int,
                tiles: int) -> torch.Tensor:
    """CLAHE's per-pixel LUT mix on a padded (th*tiles, tw*tiles) u8 image
    with (tiles^2, 256) f32 integer-valued LUTs -> u8 of the same shape."""
    if img.device.type == "cpu" and luts.device.type == "cpu":
        return clahe_apply_reference(img, luts, th, tw, tiles)
    _require_cuda(img, "clahe_apply")
    if img.device != luts.device:
        raise ValueError(f"clahe_apply: image on {img.device}, luts on {luts.device}")
    _check_padded(img, th, tw, tiles, "clahe_apply")
    if luts.dtype != torch.float32 or tuple(luts.shape) != (tiles * tiles, 256):
        raise ValueError(f"clahe_apply: luts must be ({tiles * tiles}, 256) float32, got "
                         f"{tuple(luts.shape)} {luts.dtype}")
    img, luts = img.contiguous(), luts.contiguous()
    lib = _library()
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cbv_clahe_apply(img.data_ptr(), luts.data_ptr(), out.data_ptr(),
                                 img.shape[0], img.shape[1], th, _inv(th), _inv(tw), tiles,
                                 stream)
    _raise_if(rc, lib, "clahe_apply")
    clahe_apply.launches += 1
    return out


clahe_hist.launches = 0
clahe_apply.launches = 0
