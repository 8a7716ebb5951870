"""Binding of ``bilateral.cu`` and its plain PyTorch version.

``bilateral_planar`` picks by the tensor's device alone: a CPU tensor takes
the plain version (the CPU tests run it), a CUDA tensor launches the kernel
or raises. ``bilateral_planar.launches`` counts kernel launches.

The kernel reads its color weights exp(cd * cd * gc) from a table of the
766 integer color distances cd. ``color_weight_table`` builds it on the
card once per (device, sigma_color) and caches it, so a call adds no
launch; ``color_weight_table_reference`` is its plain version.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from chessboard_vision_tpu_torch.kernels import load
from chessboard_vision_tpu_torch.ops.filters import _reflect101_pad

KERNEL_D = 9  # the kernel's disk diameter (radius 4, compiled in)
CD_LEVELS = 766  # color distances cd = sum_c |nb - center| in [0, 3 * 255]
_TABLE_LEN = 768  # the kernel's table: CD_LEVELS entries and two padding zeros
_lib = None
_tables = {}  # (device index, gc) -> the device's color-weight table
_tables_lock = threading.Lock()


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


def _gc(sigma_color: float) -> float:
    """-0.5 / sigma_color^2 rounded to f32, as the kernels use it."""
    return float(np.float32(-0.5 / (sigma_color * sigma_color)))


def bilateral_reference(img: torch.Tensor, d: int = 9, sigma_color: float = 75.0,
                        sigma_space: float = 75.0) -> torch.Tensor:
    """(3, H, W) u8 -> (3, H, W) u8 in the kernel's f32 order: per dy the
    row partials over dx, then added to the running sums."""
    r = d // 2
    gc = _gc(sigma_color)
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


def color_weight_table_reference(sigma_color: float = 75.0,
                                 device: torch.device | str = "cpu") -> torch.Tensor:
    """(766,) f32 exp((cd * cd) * gc) for cd = 0..765, by torch's exp."""
    cd = torch.arange(CD_LEVELS, dtype=torch.float32, device=device)
    return torch.exp((cd * cd) * _gc(sigma_color))


def color_weight_table(device: torch.device, sigma_color: float = 75.0) -> torch.Tensor:
    """The kernel's (766,) f32 color-weight table on a CUDA device, built by
    the card's expf at first use for this (device, sigma_color), then cached
    (read-only)."""
    return _table_buffer(device, sigma_color)[:CD_LEVELS]


def _table_buffer(device: torch.device, sigma_color: float) -> torch.Tensor:
    """The cached (768,) buffer the kernel reads: the table, then zeros."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device.index, _gc(sigma_color))
    table = _tables.get(key)
    if table is None:
        with _tables_lock, torch.cuda.device(device):
            table = _tables.get(key)
            if table is None:
                lib = _library()
                table = torch.empty(_TABLE_LEN, dtype=torch.float32, device=device)
                stream = torch.cuda.current_stream()
                rc = lib.cbv_bilateral_color_table(table.data_ptr(), key[1], stream.cuda_stream)
                if rc != 0:
                    msg = lib.cbv_cuda_error_string(rc).decode()
                    raise RuntimeError(f"bilateral color table launch failed: {msg} ({rc})")
                stream.synchronize()  # once: later calls may run on other streams
                _tables[key] = table
    return table


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load("bilateral")
        lib.cbv_bilateral.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.cbv_bilateral.restype = ctypes.c_int
        lib.cbv_bilateral_color_table.argtypes = [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.cbv_bilateral_color_table.restype = ctypes.c_int
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
    table = _table_buffer(img.device, sigma_color)
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cbv_bilateral(
            img.data_ptr(), out.data_ptr(), H, W,
            sw.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), table.data_ptr(), stream,
        )
    if rc != 0:
        msg = lib.cbv_cuda_error_string(rc).decode()
        raise RuntimeError(f"bilateral launch failed: {msg} ({rc})")
    bilateral_planar.launches += 1
    return out


bilateral_planar.launches = 0
