"""Binding of ``clahe.cu`` (histograms with LUTs, LUT apply) and plain versions.

The wrappers pick by the tensors' device alone: CPU tensors take the plain
version (the CPU tests run it), CUDA tensors launch the kernel or raise.
``clahe_hist_luts.launches``, ``clahe_hist.launches`` and
``clahe_apply.launches`` count kernel launches (the first two launch the
same histogram kernel, with and without its LUT epilogue).

The input is the unpadded (H, W) u8 plane, tiled as CLAHE tiles it: th =
ceil(H / tiles), tw = ceil(W / tiles), so (tiles - 1) * th < H <= th * tiles
(likewise W). The histograms are those of its reflect-101 pad to
(th * tiles, tw * tiles), which the kernel reads in place; a plane that is
already padded is taken as it is.

Every function takes leading board axes, (..., H, W) planes with (...,
tiles^2, 256) histograms and LUTs, each board on its own: the kernels run
all boards in one launch (the board is a grid axis), bit-equal to one
launch a board.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from chessboard_vision_tpu_torch.kernels import load
from chessboard_vision_tpu_torch.ops.filters import reflect101
from chessboard_vision_tpu_torch.ops.xla_rounding import fma

_lib = None
MAX_BOARDS = 65535  # boards a launch: the grids' y (histogram) and z (apply) extent


def _check_tiled(img: torch.Tensor, th: int, tw: int, tiles: int, what: str) -> int:
    """Raise unless ``img`` is (..., H, W) u8 that cuts into the tiles; the
    number of boards."""
    if img.dtype != torch.uint8 or img.dim() < 2:
        raise ValueError(f"{what}: expected (..., H, W) uint8 images, got {tuple(img.shape)} "
                         f"{img.dtype}")
    boards = math.prod(img.shape[:-2])
    if not 1 <= boards <= MAX_BOARDS:
        raise ValueError(f"{what}: {boards} boards, the kernel takes 1 to {MAX_BOARDS}")
    for n, size in zip(img.shape[-2:], (th, tw)):
        # the padded extent is whole tiles, padded by one reflection at most
        if not ((tiles - 1) * size < n <= size * tiles and size * tiles - n < n):
            raise ValueError(f"{what}: image {tuple(img.shape)} does not cut into {tiles}x{tiles} "
                             f"tiles of {th}x{tw}")
    return boards


def reflect_pad_end(img: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """Reflect-101 rows/cols onto the bottom and right of (..., H, W), to
    (..., hp, wp)."""
    for ax, n in ((-2, hp), (-1, wp)):
        if n > img.shape[ax]:
            img = img.index_select(ax, reflect101(torch.arange(n, device=img.device),
                                                  img.shape[ax]))
    return img


def clahe_hist_reference(img: torch.Tensor, th: int, tw: int, tiles: int) -> torch.Tensor:
    """(..., tiles^2, 256) i32 per-tile histograms of the reflect pad of
    (..., H, W) planes by one bincount over (board * tiles^2 + tile) * 256
    + value keys."""
    img = reflect_pad_end(img, th * tiles, tw * tiles)
    lead, (Hp, Wp) = img.shape[:-2], img.shape[-2:]
    boards, n = math.prod(lead), tiles * tiles
    ty = torch.arange(Hp, device=img.device) // th
    tx = torch.arange(Wp, device=img.device) // tw
    board = torch.arange(boards, device=img.device)[:, None, None] * n
    keys = ((board + ty[:, None] * tiles + tx[None, :]) * 256
            + img.reshape(boards, Hp, Wp).long())
    hist = torch.bincount(keys.reshape(-1), minlength=boards * n * 256)
    return hist.reshape(lead + (n, 256)).to(torch.int32)


def _lut_scale(area: int) -> float:
    """255 / area rounded to f32, as the JAX package computes it."""
    return float(np.float32(255.0 / area))


def clahe_luts_from_hist(hist: torch.Tensor, area: int, clip_abs: int) -> torch.Tensor:
    """(..., n_tiles, 256) i32 histograms -> (..., n_tiles, 256) f32
    integer-valued LUTs: clip, OpenCV's two-phase excess redistribution,
    scaled CDF."""
    excess = (hist - clip_abs).clamp(min=0).sum(-1, dtype=torch.int32, keepdim=True)
    hist = hist.clamp(max=clip_abs)
    batch = excess // 256
    resid = excess - batch * 256
    hist = hist + batch
    step = (256 // resid.clamp(min=1)).clamp(min=1)
    bins = torch.arange(256, dtype=torch.int32, device=hist.device)
    bump = ((bins % step) == 0) & ((bins // step) < resid)
    cdf = torch.cumsum(hist + bump.to(torch.int32), -1, dtype=torch.int32)
    return torch.round(cdf.float() * _lut_scale(area)).clamp(0, 255)


def clahe_hist_luts_reference(img: torch.Tensor, th: int, tw: int, tiles: int,
                              clip_abs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reflect pad's per-tile histograms and the LUTs built from them."""
    hist = clahe_hist_reference(img, th, tw, tiles)
    return hist, clahe_luts_from_hist(hist, th * tw, clip_abs)


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
    fma(fx, ey1, (1 - fx) * ey0) (clahe.cu says why). (..., H, W) planes,
    each with its own board's (..., tiles^2, 256) LUTs."""
    H, W = img.shape[-2:]
    y0, y1, fy = (a[:, None] for a in _tile_coords(H, th, tiles, img.device))
    x0, x1, fx = (a[None, :] for a in _tile_coords(W, tw, tiles, img.device))
    flat = luts.reshape(-1)
    n = tiles * tiles * 256
    # each pixel's value plus its board's offset into the flat LUTs
    v = img.long() + (torch.arange(flat.numel() // n, device=img.device) * n).reshape(
        img.shape[:-2] + (1, 1))

    def e(ty, tx):
        return flat[(ty * tiles + tx) * 256 + v]

    gy0, gx0 = 1.0 - fy, 1.0 - fx
    ey0 = fma(e(y0, x0), gy0, fy * e(y1, x0))
    ey1 = fma(e(y0, x1), gy0, fy * e(y1, x1))
    res = torch.where(x0 == x1, (gx0 + fx) * ey0, fma(ey1, fx, gx0 * ey0))
    return torch.round(res).clamp(0, 255).to(torch.uint8)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a built ``clahe.cu`` library."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn, args in (
        (lib.cbv_clahe_hist, [P, I, I, I, I, I, I, P, P, I, F, P]),
        (lib.cbv_clahe_apply, [P, P, P, I, I, I, F, F, I, P]),
    ):
        fn.argtypes, fn.restype = args, I
    lib.cbv_cuda_error_string.argtypes = [I]
    lib.cbv_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(load("clahe"))
    return _lib


def _raise_if(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.cbv_cuda_error_string(rc).decode()} ({rc})")


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {t.device}, expected CPU or CUDA")


def _launch_hist(img: torch.Tensor, th: int, tw: int, tiles: int, clip_abs: int | None,
                 what: str):
    """One histogram launch for every board: hist, and the LUTs unless
    clip_abs is None."""
    _require_cuda(img, what)
    boards = _check_tiled(img, th, tw, tiles, what)
    img = img.contiguous()
    lib = _library()
    shape = img.shape[:-2] + (tiles * tiles, 256)
    hist = torch.empty(shape, dtype=torch.int32, device=img.device)
    luts = None if clip_abs is None else torch.empty(shape, dtype=torch.float32,
                                                     device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cbv_clahe_hist(
            img.data_ptr(), boards, img.shape[-2], img.shape[-1], th, tw, tiles,
            hist.data_ptr(), None if luts is None else luts.data_ptr(),
            0 if clip_abs is None else int(clip_abs), _lut_scale(th * tw), stream,
        )
    _raise_if(rc, lib, what)
    return hist, luts


def clahe_hist(img: torch.Tensor, th: int, tw: int, tiles: int) -> torch.Tensor:
    """Per-tile 256-bin histograms of the reflect pad of (..., H, W) u8
    planes -> (..., tiles^2, 256) i32."""
    if img.device.type == "cpu":
        return clahe_hist_reference(img, th, tw, tiles)
    hist, _ = _launch_hist(img, th, tw, tiles, None, "clahe_hist")
    clahe_hist.launches += 1
    return hist


def clahe_hist_luts(img: torch.Tensor, th: int, tw: int, tiles: int,
                    clip_abs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """CLAHE's histogram and LUT phases in one launch for (..., H, W) u8
    planes: the reflect pad's (..., tiles^2, 256) i32 histograms and the
    (..., tiles^2, 256) f32 LUTs that ``clahe_luts_from_hist(hist, th * tw,
    clip_abs)`` builds from them."""
    if img.device.type == "cpu":
        return clahe_hist_luts_reference(img, th, tw, tiles, clip_abs)
    out = _launch_hist(img, th, tw, tiles, clip_abs, "clahe_hist_luts")
    clahe_hist_luts.launches += 1
    return out


def clahe_apply(img: torch.Tensor, luts: torch.Tensor, th: int, tw: int,
                tiles: int) -> torch.Tensor:
    """CLAHE's per-pixel LUT mix on (..., H, W) u8 planes (padded or not),
    each with its board's (..., tiles^2, 256) f32 integer-valued LUTs -> u8
    of the planes' shape; on a card all boards in one launch."""
    want = tuple(img.shape[:-2]) + (tiles * tiles, 256)
    if tuple(luts.shape) != want:
        raise ValueError(f"clahe_apply: luts must be {want} for images {tuple(img.shape)}, "
                         f"got {tuple(luts.shape)}")
    if img.device.type == "cpu" and luts.device.type == "cpu":
        return clahe_apply_reference(img, luts, th, tw, tiles)
    _require_cuda(img, "clahe_apply")
    if img.device != luts.device:
        raise ValueError(f"clahe_apply: image on {img.device}, luts on {luts.device}")
    boards = _check_tiled(img, th, tw, tiles, "clahe_apply")
    if luts.dtype != torch.float32:
        raise ValueError(f"clahe_apply: luts must be float32, got {luts.dtype}")
    img, luts = img.contiguous(), luts.contiguous()
    lib = _library()
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cbv_clahe_apply(img.data_ptr(), luts.data_ptr(), out.data_ptr(), boards,
                                 img.shape[-2], img.shape[-1], _inv(th), _inv(tw), tiles,
                                 stream)
    _raise_if(rc, lib, "clahe_apply")
    clahe_apply.launches += 1
    return out


clahe_hist.launches = 0
clahe_hist_luts.launches = 0
clahe_apply.launches = 0
