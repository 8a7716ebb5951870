# Frozen copy of chessboard_vision_tpu_torch/ops/hough.py at commit 9f9af32, for the
# benchmark's plain reference: imports rewritten to this folder, nothing else
# changed unless a "reference:" comment says so.
"""Exact Hough circle transform on all squares at once (the ``exact`` backend).

Counterpart of chessboard_vision_tpu.ops.hough: OpenCV's HOUGH_GRADIENT
(dp=1.2, minDist=min_dim//3, param1=100, param2=25, radii 20-55% of the
square; reference piece_detector.py:210-270) for a batch of squares. Canny
with the exact hysteresis -> fixed-point ray voting into per-square
accumulators -> local-maxima center candidates -> a top-K scan that takes
the best candidate, estimates its radius with OpenCV's run scan over the
sorted edge distances, and suppresses its minDist disk.

The voting is one int32 scatter-add per chunk of 8 radii into the
(n, acc_h*acc_w) accumulators (the JAX package's vmap-of-1-D scatter form is
a TPU layout device): integer adds do not depend on their order, so the
accumulators equal the JAX package's bit for bit. On the card every pixel
of every square takes a lane, so the voting never waits on the device
(gathering the voting pixels would read their count back); on the CPU
the voting pixels are gathered first (their count costs nothing there),
which gives the same sums from a tenth of the lanes and a third of the
time (a 1280x720 exact step on one thread: ~250 against ~800 ms; the
golden clips: ~120 against ~240 s). The f32 distances round as
the jitted JAX program does, where XLA:CPU contracts ``a*a + b*b`` into one
fused multiply-add (ops/xla_rounding.py), and every square root is rounded
correctly, as XLA's is: torch's f32 sqrt on the CPU is off by an ulp on some
inputs, so it is taken in float64. Plain torch, no custom kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device
from .canny import canny
from .filters import sobel3
from .xla_rounding import fma

_SHIFT = 10
_ONE = 1 << _SHIFT
_CHUNK = 8  # radii per scatter


def _f32(v: float) -> float:
    """``v`` rounded to f32: the constant an f32 JAX expression uses."""
    return float(np.float32(v))


class HoughBounds(NamedTuple):
    """Static (python-int) loop and shape bounds over all squares."""

    r_lo: int
    r_hi: int
    acc_h: int  # max arows + 2
    acc_w: int  # max acols + 2


class HoughParams(NamedTuple):
    """Per-square scalars of the circle search (paired with HoughBounds)."""

    min_radius: torch.Tensor  # (n,) i32
    max_radius: torch.Tensor  # (n,) i32
    min_dist: torch.Tensor  # (n,) f32
    arows: torch.Tensor  # (n,) i32 accumulator rows (ceil(h/dp))
    acols: torch.Tensor  # (n,) i32

    @classmethod
    def from_geometry(cls, heights, widths, dp=1.2, min_ratio=0.20, max_ratio=0.55,
                      device="cuda"):
        """(params on ``device``, bounds) from the squares' sizes."""
        device = resolve_device(device, "HoughParams.from_geometry")
        heights = np.asarray(heights)
        widths = np.asarray(widths)
        min_dim = np.minimum(heights, widths)
        min_r = (min_dim * min_ratio).astype(np.int32)
        max_r = (min_dim * max_ratio).astype(np.int32)
        idp = 1.0 / dp
        arows = np.ceil(heights * idp).astype(np.int32)
        acols = np.ceil(widths * idp).astype(np.int32)

        def t(a):
            return torch.as_tensor(a, device=device)

        params = cls(
            min_radius=t(min_r),
            max_radius=t(max_r),
            min_dist=t((min_dim // 3).astype(np.float32)),
            arows=t(arows),
            acols=t(acols),
        )
        bounds = HoughBounds(
            r_lo=int(min_r.min()),
            r_hi=int(max_r.max()),
            acc_h=int(arows.max()) + 2,
            acc_w=int(acols.max()) + 2,
        )
        return params, bounds


class HoughCircles(NamedTuple):
    """Top-K circles per square (fixed K, masked by ``found``)."""

    found: torch.Tensor  # (n, K) bool
    cx: torch.Tensor  # (n, K) f32 full-resolution center x
    cy: torch.Tensor  # (n, K) f32
    radius: torch.Tensor  # (n, K) f32
    votes: torch.Tensor  # (n, K) i32


def _vote(edges, dx, dy, p: HoughParams, b: HoughBounds, dp: float,
          compact=None) -> torch.Tensor:
    """Fixed-point ray voting (the cv2 scheme) -> (n, acc_h, acc_w) i32.
    compact: gather the voting pixels first (default: on the CPU only; the
    tests hold both forms on the CPU)."""
    n_sq, H, W = edges.shape
    dev = edges.device
    idp = _f32(1.0 / dp)
    vx, vy = dx.float(), dy.float()
    # Sobel values are integers, so vx*vx + vy*vy is exact in f32 however
    # it is contracted; the f32 divide is correctly rounded.
    safe_mag = _sqrt(vx * vx + vy * vy).clamp(min=1.0)
    sx = torch.round(vx * idp * _ONE / safe_mag).to(torch.int32).reshape(n_sq, 1, -1)
    sy = torch.round(vy * idp * _ONE / safe_mag).to(torch.int32).reshape(n_sq, 1, -1)
    xs = torch.arange(W, device=dev, dtype=torch.float32)
    ys = torch.arange(H, device=dev, dtype=torch.float32)
    x0 = torch.round(xs * idp * _ONE).to(torch.int32)[None, :].expand(H, W).reshape(1, 1, -1)
    y0 = torch.round(ys * idp * _ONE).to(torch.int32)[:, None].expand(H, W).reshape(1, 1, -1)
    voter = (edges & ((dx != 0) | (dy != 0))).reshape(n_sq, 1, -1)

    acw = b.acc_w
    flat_cells = b.acc_h * acw
    acc = torch.zeros((n_sq, flat_cells), dtype=torch.int32, device=dev)
    n_chunks = -(-(b.r_hi - b.r_lo + 1) // _CHUNK)
    steps = torch.arange(_CHUNK, device=dev, dtype=torch.int32)[None, :, None]
    if compact if compact is not None else dev.type == "cpu":
        sq, pix = voter[:, 0].nonzero(as_tuple=True)  # one lane a voting pixel
        sx, sy = sx[sq, 0, pix], sy[sq, 0, pix]
        x0, y0 = x0[0, 0, pix], y0[0, 0, pix]
        base = sq * flat_cells
        arows, acols = p.arows[sq], p.acols[sq]
        rmin, rmax = p.min_radius[sq], p.max_radius[sq]
        for ci in range(n_chunks):
            r = b.r_lo + ci * _CHUNK + steps[0]  # (CHUNK, 1)
            in_range = (r >= rmin) & (r <= rmax) & (r <= b.r_hi)
            for sgn in (1, -1):
                x2 = (x0 + sgn * r * sx) >> _SHIFT  # (CHUNK, voters)
                y2 = (y0 + sgn * r * sy) >> _SHIFT
                valid = in_range & (x2 >= 0) & (x2 < acols) & (y2 >= 0) & (y2 < arows)
                cells = (base + (y2 + 1) * acw + (x2 + 1))[valid]
                acc.view(-1).index_add_(0, cells, torch.ones_like(cells, dtype=torch.int32))
        return acc.reshape(n_sq, b.acc_h, acw)

    arows = p.arows[:, None, None]
    acols = p.acols[:, None, None]
    rmin = p.min_radius[:, None, None]
    rmax = p.max_radius[:, None, None]
    for ci in range(n_chunks):
        r = b.r_lo + ci * _CHUNK + steps  # (1, CHUNK, 1)
        in_range = (r >= rmin) & (r <= rmax) & (r <= b.r_hi)
        targets, valids = [], []
        for sgn in (1, -1):
            x2 = (x0 + sgn * r * sx) >> _SHIFT  # (n, CHUNK, H*W)
            y2 = (y0 + sgn * r * sy) >> _SHIFT
            inb = (x2 >= 0) & (x2 < acols) & (y2 >= 0) & (y2 < arows)
            valids.append(voter & in_range & inb)
            targets.append(((y2 + 1) * acw + (x2 + 1)).clamp(0, flat_cells - 1))
        idx = torch.cat(targets, dim=1).reshape(n_sq, -1).to(torch.int64)
        val = torch.cat(valids, dim=1).reshape(n_sq, -1).to(torch.int32)
        acc.scatter_add_(1, idx, val)
    return acc.reshape(n_sq, b.acc_h, acw)


def _center_candidates(acc: torch.Tensor, p: HoughParams, param2: int) -> torch.Tensor:
    """Local maxima above threshold inside each square's accumulator: the
    cell's votes, else -1. (n, acc_h - 2, acc_w - 2) i32."""
    v = acc[:, 1:-1, 1:-1]
    left, right = acc[:, 1:-1, :-2], acc[:, 1:-1, 2:]
    up, down = acc[:, :-2, 1:-1], acc[:, 2:, 1:-1]
    ah, aw = v.shape[1], v.shape[2]
    cx = torch.arange(aw, device=acc.device)[None, None, :]
    cy = torch.arange(ah, device=acc.device)[None, :, None]
    inside = (cx < p.acols[:, None, None]) & (cy < p.arows[:, None, None])
    cand = (v > param2) & (v > left) & (v >= right) & (v > up) & (v >= down) & inside
    return torch.where(cand, v, -1)


def _sq_dist(ax: torch.Tensor, ay: torch.Tensor) -> torch.Tensor:
    """ax*ax + ay*ay in f32, rounded as XLA:CPU's contraction
    fma(ax, ax, ay*ay) rounds it."""
    return fma(ax, ax, ay * ay)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (float64 holds it exactly
    enough that one rounding to f32 is correct)."""
    return torch.sqrt(x.double()).float()


def _radius_support(sorted_d: torch.Tensor, s_idx0: torch.Tensor, dr: float, n_runs: int):
    """OpenCV's greedy run scan over descending sorted distances.

    sorted_d: (n, N) ascending, -inf for entries that are not edge pixels
    in the radius range. s_idx0: (n,) index where the scan starts (the
    largest distance). Returns (r_best, max_count) per square."""
    n, N = sorted_d.shape
    dev = sorted_d.device
    s_idx = s_idx0.to(torch.int64)
    r_best = torch.zeros(n, dtype=torch.float32, device=dev)
    max_count = torch.zeros(n, dtype=torch.int64, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    dr = _f32(dr)
    for _ in range(n_runs):
        start_d = sorted_d.gather(1, s_idx[:, None])[:, 0]
        thresh = start_d - dr
        # The first index whose value is >= thresh, i.e. the count of
        # values below it (the JAX package sums the comparison instead).
        j_first = torch.searchsorted(sorted_d, thresh[:, None].contiguous())[:, 0]
        j = j_first - 1  # the trigger: the largest index with a value < thresh
        j_safe = j.clamp(0, N - 1)
        trig_d = sorted_d.gather(1, j_safe[:, None])[:, 0]
        has_trigger = (j >= 0) & (trig_d > -math.inf) & ~done
        count = s_idx - j
        mid = (torch.div(j + s_idx, 2, rounding_mode="floor") + 1).clamp(0, N - 1)
        r_cur = sorted_d.gather(1, mid[:, None])[:, 0]
        take = has_trigger & (
            (count.float() * r_best >= max_count.float() * r_cur)
            | ((r_best < _f32(1e-7)) & (count >= max_count))
        )
        r_best = torch.where(take, r_cur, r_best)
        max_count = torch.where(take, count, max_count)
        s_idx = torch.where(has_trigger, j_safe, s_idx)
        done = done | ~has_trigger
    return r_best, max_count.to(torch.int32)


def hough_circles(gray: torch.Tensor, p: HoughParams, b: HoughBounds, dp: float = 1.2,
                  param1: int = 100, param2: int = 25, top_k: int = 4) -> HoughCircles:
    """Up to top_k circles per square. gray: (n, H, W) u8 (pre-blurred)."""
    n_sq, H, W = gray.shape
    dev = gray.device
    edges = canny(gray, max(param1 // 2, 1), param1)
    dx, dy = sobel3(gray, border="reflect101")
    acc = _vote(edges, dx, dy, p, b, dp)
    cand = _center_candidates(acc, p, param2)
    ah, aw = cand.shape[1], cand.shape[2]

    dpf = _f32(dp)
    xs = torch.arange(W, device=dev, dtype=torch.float32)[None, None, :]
    ys = torch.arange(H, device=dev, dtype=torch.float32)[None, :, None]
    rmin2 = (p.min_radius.float() ** 2)[:, None, None]
    rmax2 = (p.max_radius.float() ** 2)[:, None, None]
    n_runs = int(np.ceil((b.r_hi - b.r_lo) / dp)) + 4
    gcx = (torch.arange(aw, device=dev, dtype=torch.float32) + 0.5) * dpf
    gcy = (torch.arange(ah, device=dev, dtype=torch.float32) + 0.5) * dpf
    min_dist2 = (p.min_dist ** 2)[:, None, None]
    cells = torch.arange(ah * aw, device=dev).reshape(1, ah, aw)
    s_idx0 = torch.full((n_sq,), H * W - 1, dtype=torch.int64, device=dev)

    outs = []
    for _ in range(top_k):
        flat = cand.reshape(n_sq, -1)
        best = torch.argmax(flat, dim=-1)  # the first index of the max
        votes = flat.gather(1, best[:, None])[:, 0]
        exists = votes > param2
        ccx = ((best % aw).float() + 0.5) * dpf
        ccy = (torch.div(best, aw, rounding_mode="floor").float() + 0.5) * dpf

        d2 = _sq_dist(xs - ccx[:, None, None], ys - ccy[:, None, None])
        valid = edges & (d2 >= rmin2) & (d2 <= rmax2)
        dvals = torch.where(valid, _sqrt(d2), -math.inf).reshape(n_sq, -1)
        sorted_d = torch.sort(dvals, dim=-1).values
        has_any = sorted_d[:, -1] > -math.inf
        r_best, max_count = _radius_support(sorted_d, s_idx0, dp, n_runs)
        accept = exists & (max_count > param2) & has_any

        # Suppress: an accepted circle its minDist disk of cells, a rejected
        # pick its own cell.
        cell_d2 = _sq_dist(gcx[None, None, :] - ccx[:, None, None],
                           gcy[None, :, None] - ccy[:, None, None])
        in_disk = cell_d2 < min_dist2
        is_picked = cells == best[:, None, None]
        cand = torch.where(torch.where(accept[:, None, None], in_disk, is_picked), -1, cand)
        outs.append((accept, ccx, ccy, r_best, votes))
    found, cx, cy, radius, votes = (torch.stack(f, dim=1) for f in zip(*outs))
    return HoughCircles(found=found, cx=cx, cy=cy, radius=radius, votes=votes)


def best_circle_near_center(circles: HoughCircles, heights, widths, center_window: float = 0.3):
    """Reference selection (piece_detector.py:243-268): among found circles,
    those whose center lies within center_window*min_dim of the square's
    center; the closest wins. Returns (found, cx, cy, radius_int, is_small)
    with is_small = radius < 20% of min_dim ('tower_top')."""
    h, w = heights.float(), widths.float()
    min_dim = torch.minimum(h, w)
    cx0 = torch.floor(w / 2)[:, None]
    cy0 = torch.floor(h / 2)[:, None]
    d = _sqrt(_sq_dist(circles.cx - cx0, circles.cy - cy0))
    in_win = circles.found & (d < (min_dim * _f32(center_window))[:, None])
    pick = torch.argmin(torch.where(in_win, d, math.inf), dim=-1)[:, None]  # first index

    def sel(a):
        return a.gather(1, pick)[:, 0]

    r_int = torch.floor(sel(circles.radius)).to(torch.int32)
    is_small = r_int.float() < min_dim * _f32(0.20)
    return in_win.any(dim=-1), sel(circles.cx), sel(circles.cy), r_int, is_small
