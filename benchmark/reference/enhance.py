# Frozen copy of the plain versions of the port's enhancement kernels at
# commit b8e261e, for the benchmark's plain reference: from
# chessboard_vision_tpu_torch/kernels/bilateral.py (``space_weights``, ``_gc``,
# ``bilateral_reference``), kernels/clahe.py (``reflect_pad_end``,
# ``clahe_hist_reference``, ``_lut_scale``, ``clahe_luts_from_hist``,
# ``clahe_hist_luts_reference``, ``_inv``, ``_tile_coords``,
# ``clahe_apply_reference``), the tiling of ops/enhance.py (``clahe``) and the
# stages of models/enhancer.py (``correct_lighting``, ``enhance_planar``);
# imports rewritten to this folder, nothing else changed unless a
# "reference:" comment says so.
"""The five-stage enhancement of boards in plain torch, no kernel.

hericmr/chessboard-vision ``frame_enhancer.py:161-181`` (``process_pipeline``):
(0) the HSV color profile, (1) CLAHE clip 3.0 on 8x8 tiles of the Lab L
plane, (2) the bilateral filter d = 9, sigma 75/75, (3) the 3x3 sharpen,
(4) min-max normalize to [0, 255]. ``enhance`` runs them on planar (..., 3,
B, B) u8 boards, each board on its own. Stage 0 is the identity: a checkout
holds no ``color_profile.json``, and upstream without the file leaves the
frame as it is.

The arithmetic is that of the port's plain versions, which its kernels
match bit for bit: the bilateral sums in f32, per row of taps the row's
partial sums first, with the color weight exp(cd * cd * gc) of the integer
L1 color distance cd over the three channels; CLAHE's histograms are those of
the plane's reflect-101 pad to whole tiles, its LUTs OpenCV's clip and
two-phase excess redistribution, and its apply mixes the four neighbour
tiles' LUTs in f32 with fused multiply-adds where the TPU kernel has them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .color import planar_bgr2lab, planar_lab2bgr
from .filters import _reflect101_pad, normalize_minmax, reflect101, sharpen
from .xla_rounding import fma

D, SIGMA_COLOR, SIGMA_SPACE = 9, 75.0, 75.0  # the bilateral's published sizes
CLAHE_CLIP, CLAHE_TILES = 3.0, 8  # CLAHE's


# -- the bilateral filter (kernels/bilateral.py) --------------------------------


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
    """(..., 3, H, W) u8 -> (..., 3, H, W) u8 in the kernel's f32 order: per
    dy the row partials over dx, then added to the running sums; each board
    on its own."""
    r = d // 2
    gc = _gc(sigma_color)
    sw = space_weights(d, sigma_space)
    H, W = img.shape[-2:]
    p = _reflect101_pad(img, r).float()
    center = p[..., :, r : r + H, r : r + W]
    num = den = 0.0
    for dy in range(d):
        rn = rd = 0.0
        for dx in range(d):
            if sw[dy, dx] == 0.0:
                continue
            nb = p[..., :, dy : dy + H, dx : dx + W]
            cd = (nb - center).abs().sum(-3, keepdim=True)  # (..., 1, H, W)
            w = float(sw[dy, dx]) * torch.exp(cd * cd * gc)
            rn = rn + w * nb
            rd = rd + w
        num = num + rn
        den = den + rd
    return torch.round(num / den).clamp(0, 255).to(torch.uint8)


# -- CLAHE (kernels/clahe.py) -----------------------------------------------------


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
    fma(fx, ey1, (1 - fx) * ey0). (..., H, W) planes, each with its own
    board's (..., tiles^2, 256) LUTs."""
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


def clahe(img: torch.Tensor, clip_limit: float = 3.0, tiles: int = 8) -> torch.Tensor:
    """cv2.createCLAHE(clip_limit, (tiles, tiles)).apply on (..., H, W) u8
    (ops/enhance.py ``clahe``, its plain branch)."""
    H, W = img.shape[-2:]
    th, tw = -(-H // tiles), -(-W // tiles)
    area = th * tw
    clip_abs = max(int(clip_limit * area / 256), 1)
    _, luts = clahe_hist_luts_reference(img, th, tw, tiles, clip_abs)
    return clahe_apply_reference(img, luts, th, tw, tiles)


# -- the stages (models/enhancer.py) ------------------------------------------------


def correct_lighting(planar: torch.Tensor, clahe_clip: float = 3.0,
                     clahe_tiles: int = 8) -> torch.Tensor:
    """CLAHE on the L channel of a Lab round trip, (..., 3, H, W) u8."""
    lab = planar_bgr2lab(planar)
    l_enh = clahe(lab[..., 0, :, :].contiguous(), clahe_clip, clahe_tiles)
    return planar_lab2bgr(torch.cat([l_enh.unsqueeze(-3), lab[..., 1:, :, :]], -3))


def reduce_noise(planar: torch.Tensor) -> torch.Tensor:
    """The bilateral filter at its published sizes (models/enhancer.py
    ``bilateral``, its plain branch)."""
    return bilateral_reference(planar, D, SIGMA_COLOR, SIGMA_SPACE)


def enhance(boards: torch.Tensor) -> torch.Tensor:
    """Stages 1-4 on (..., 3, B, B) u8 boards, each on its own (stage 0, the
    identity, left out): CLAHE on Lab-L -> bilateral -> sharpen -> min-max
    normalize (models/enhancer.py ``enhance_planar``)."""
    x = correct_lighting(boards, CLAHE_CLIP, CLAHE_TILES)
    return normalize_minmax(sharpen(reduce_noise(x)))
