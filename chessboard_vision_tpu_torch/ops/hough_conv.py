"""Conv circle detector: gradient-weighted annular correlation + ray votes.

Counterpart of chessboard_vision_tpu.ops.hough_conv (see its module doc for
the cos(2*theta) ring-correlation derivation). ``ConvHoughPlan.build`` is
the JAX package's numpy plan builder, unchanged but for ``k_align``: on a
CUDA device the basis's K is padded with zero columns to a multiple of 8,
the row stride TMA needs, and ``edge_planes`` gives the planes the same
zero tail (on the CPU the plan keeps the JAX package's K). ``find_circle``
proposes one (center, radius) per square with the score matmul, which runs
the hand-written CUDA kernel (kernels/score_matmul.cu) on CUDA tensors, and
verifies it with cv2-semantics ray votes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from chessboard_vision_tpu_torch.kernels.score_matmul import score_matmul
from chessboard_vision_tpu_torch.ops.canny import canny
from chessboard_vision_tpu_torch.ops.filters import sobel3
from chessboard_vision_tpu_torch.ops.xla_rounding import fma

# Row padding of the basis, kept from the JAX plan (its Pallas kernel's
# M-tile) so the two plans are equal array for array.
_SCORE_MBLOCK = 256
# Lateral miss (px) within which an edge pixel's gradient ray votes for a
# center: absorbs the q-cell center quantization plus cv2's dp cell.
_VOTE_TOL = 2.5


class ConvHoughDims(NamedTuple):
    """Static (python-int) shape parameters."""

    ksize: int
    win_h: int
    win_w: int
    pad: int
    downsample: int
    woy: tuple  # (64,) window row offsets (accumulator units)
    wox: tuple  # (64,) window col offsets
    union_y0: int  # union-window top (accumulator units) across squares
    union_x0: int
    union_h: int  # Yu: union-window rows the basis matmul produces
    union_w: int  # Xu
    hysteresis_rounds: int = -1  # -1 exact fixpoint; k>=0 bounded


class ConvHoughPlan(NamedTuple):
    """Constants of the conv circle search (paired with ConvHoughDims)."""

    kernels: torch.Tensor  # (2, R, K, K) f32 ring kernels (ux^2-uy^2, 2*ux*uy)
    radii: torch.Tensor  # (R,) f32 bin center radii
    r_valid: torch.Tensor  # (64, R) bool — radius inside square's [minR,maxR]
    r_min: torch.Tensor  # (64,) f32 per-square min radius (full-res px)
    r_max: torch.Tensor  # (64,) f32 per-square max radius
    win_offset_y: torch.Tensor  # (64,) i32 window top in square coords
    win_offset_x: torch.Tensor  # (64,) i32
    win_mask: torch.Tensor  # (Wy, Wx, 64) bool — centers within 30% of center
    basis: torch.Tensor  # (Mq, 2*Hq*Wq + zero columns up to k_align) bf16 —
    #   ring kernels unrolled over the union of the per-square center
    #   windows, row-pruned to the (r, y, x) cells some square accepts,
    #   padded to _SCORE_MBLOCK rows
    kvalid: torch.Tensor  # (Mq, 64) bool — kept row valid for square s
    kept_code: torch.Tensor  # (Mq,) i32 — kept row's flat (r*Yu + y)*Xu + x

    @classmethod
    def build(
        cls,
        heights,
        widths,
        min_ratio: float = 0.20,
        max_ratio: float = 0.55,
        r_step: float = 3.0,
        delta: float = 1.2,
        center_window: float = 0.3,
        downsample: int = 3,
        plane_h: int = None,
        plane_w: int = None,
        hysteresis_rounds: int = -1,
        device="cpu",
        k_align: int = None,
    ):
        """Kernels and windows live in accumulator space (planes sum-pooled
        by ``downsample``); radii/coordinates are reported back in full
        resolution. ``k_align`` pads the basis's K with zero columns to a
        multiple of it (the sums do not change); by default
        ``k_align_for(device)``: 8 on a CUDA device, else 1 (JAX's K)."""
        heights = np.asarray(heights)
        widths = np.asarray(widths)
        q = downsample
        min_dim = np.minimum(heights, widths)
        minR = (min_dim * min_ratio).astype(np.int64)
        maxR = (min_dim * max_ratio).astype(np.int64)
        r_lo, r_hi = int(minR.min()), int(maxR.max())
        radii = np.arange(r_lo, r_hi + 1, r_step, dtype=np.float64)
        R = len(radii)

        r_hi_ds = r_hi / q
        K = 2 * (int(np.ceil(r_hi_ds + delta))) + 1
        c = K // 2
        yy, xx = np.mgrid[:K, :K]
        dy = (yy - c).astype(np.float64)
        dx = (xx - c).astype(np.float64)
        dist = np.sqrt(dy * dy + dx * dx)
        with np.errstate(invalid="ignore", divide="ignore"):
            ux = np.where(dist > 0, dx / dist, 0.0)
            uy = np.where(dist > 0, dy / dist, 0.0)
        kernels = np.zeros((2, R, K, K), np.float32)
        for i, r in enumerate(radii):
            ring = (np.abs(dist - r / q) <= delta) & (dist > 0)
            kernels[0, i] = (ring * (ux * ux - uy * uy)).astype(np.float32)
            kernels[1, i] = (ring * 2.0 * ux * uy).astype(np.float32)

        r_valid = (radii[None, :] >= minR[:, None]) & (radii[None, :] <= maxR[:, None])

        # Center window (accumulator units): 30% of min_dim around center.
        win = (min_dim * center_window / q).astype(np.int64)
        Wy = int(2 * win.max() + 1)
        Wx = Wy
        cy_ds = (heights // 2) // q
        cx_ds = (widths // 2) // q
        sq_plane_h = heights // q
        sq_plane_w = widths // q
        woy = np.clip(cy_ds - win, 0, np.maximum(sq_plane_h - Wy, 0)).astype(np.int64)
        wox = np.clip(cx_ds - win, 0, np.maximum(sq_plane_w - Wx, 0)).astype(np.int64)
        mask = np.zeros((64, Wy, Wx), bool)
        for s in range(64):
            ys = woy[s] + np.arange(Wy)
            xs = wox[s] + np.arange(Wx)
            d = np.sqrt(
                (ys[:, None] - cy_ds[s]) ** 2.0 + (xs[None, :] - cx_ds[s]) ** 2.0
            )
            inb = (
                (ys[:, None] >= 0)
                & (ys[:, None] < heights[s] // q)
                & (xs[None, :] >= 0)
                & (xs[None, :] < widths[s] // q)
            )
            mask[s] = (d < min_dim[s] * center_window / q) & inb
        # Unroll the ring kernels into one basis matrix: rows index the
        # output cell (r, y, x) of the union window, columns the flattened
        # pooled input (plane, py, px); out-of-plane taps are zero.
        plane_h_full = int(heights.max()) if plane_h is None else int(plane_h)
        plane_w_full = int(widths.max()) if plane_w is None else int(plane_w)
        Hq, Wq = plane_h_full // q, plane_w_full // q
        y0, x0 = int(woy.min()), int(wox.min())
        Yu = int(woy.max()) + Wy - y0
        Xu = int(wox.max()) + Wx - x0
        dy = np.arange(Hq)[:, None] - (y0 + np.arange(Yu))[None, :] + c  # (Hq, Yu)
        dxm = np.arange(Wq)[:, None] - (x0 + np.arange(Xu))[None, :] + c  # (Wq, Xu)
        vy = (dy >= 0) & (dy < K)
        vx = (dxm >= 0) & (dxm < K)
        t = kernels[:, :, np.clip(dy, 0, K - 1).reshape(-1), :]  # (2,R,Hq*Yu,K)
        t = t[:, :, :, np.clip(dxm, 0, K - 1).reshape(-1)]  # (2,R,Hq*Yu,Wq*Xu)
        t = t.reshape(2, R, Hq, Yu, Wq, Xu)
        t = t * vy[None, None, :, :, None, None]
        t = t * vx[None, None, None, None, :, :]
        basis = np.ascontiguousarray(t.transpose(1, 3, 5, 0, 2, 4)).reshape(
            R * Yu * Xu, 2 * Hq * Wq
        )
        # Row pruning: keep the (r, y, x) cells that some square accepts
        # (radius in its band AND cell in its circular window). Kept rows
        # stay (r, y, x)-lexicographic, so first-max tie-breaking matches
        # the dense form per square.
        yy_u = y0 + np.arange(Yu)
        xx_u = x0 + np.arange(Xu)
        by = yy_u[None, :] - woy[:, None]  # (64, Yu) window-relative row
        bx = xx_u[None, :] - wox[:, None]  # (64, Xu)
        in_win = (
            ((by >= 0) & (by < Wy))[:, :, None]
            & ((bx >= 0) & (bx < Wx))[:, None, :]
        )  # (64, Yu, Xu)
        cell_ok = np.zeros((64, Yu, Xu), bool)
        for s in range(64):
            byc = np.clip(by[s], 0, Wy - 1)
            bxc = np.clip(bx[s], 0, Wx - 1)
            cell_ok[s] = in_win[s] & mask[s][byc[:, None], bxc[None, :]]
        valid_full = (
            r_valid[:, :, None, None] & cell_ok[:, None, :, :]
        )  # (64, R, Yu, Xu)
        valid_full = valid_full.reshape(64, R * Yu * Xu).T  # (M, 64)
        kept = np.flatnonzero(valid_full.any(axis=1))
        basis = basis[kept]
        kvalid = valid_full[kept]
        MB = _SCORE_MBLOCK
        Mq = -(-basis.shape[0] // MB) * MB
        pad_rows = Mq - basis.shape[0]
        if k_align is None:
            k_align = k_align_for(device)
        basis = np.pad(basis, ((0, pad_rows), (0, -basis.shape[1] % k_align)))
        kvalid = np.pad(kvalid, ((0, pad_rows), (0, 0)))
        kept_code = np.pad(kept.astype(np.int32), (0, pad_rows))

        def t_(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

        plan = cls(
            kernels=t_(kernels),
            radii=t_(radii.astype(np.float32)),
            r_valid=t_(r_valid),
            r_min=t_(minR.astype(np.float32)),
            r_max=t_(maxR.astype(np.float32)),
            win_offset_y=t_(woy.astype(np.int32)),
            win_offset_x=t_(wox.astype(np.int32)),
            win_mask=t_(mask.transpose(1, 2, 0)),
            # f32 -> bf16 round-to-nearest-even, as jnp.asarray(..., bf16)
            basis=t_(basis.astype(np.float32)).to(torch.bfloat16),
            kvalid=t_(kvalid),
            kept_code=t_(kept_code),
        )
        dims = ConvHoughDims(
            ksize=K, win_h=Wy, win_w=Wx, pad=c, downsample=q,
            woy=tuple(int(v) for v in woy), wox=tuple(int(v) for v in wox),
            union_y0=y0, union_x0=x0, union_h=Yu, union_w=Xu,
            hysteresis_rounds=hysteresis_rounds,
        )
        return plan, dims


def k_align_for(device) -> int:
    """The basis's K alignment a plan on ``device`` takes by default: 8 on
    CUDA (16-byte bf16 rows, which the kernel's TMA loads need), else 1."""
    return 8 if torch.device(device).type == "cuda" else 1


class ConvCircle(NamedTuple):
    found: torch.Tensor  # (64,) bool
    cx: torch.Tensor  # (64,) f32
    cy: torch.Tensor  # (64,) f32
    radius: torch.Tensor  # (64,) i32
    score: torch.Tensor  # (64,) f32 peak annular support (proposal stage)
    votes: torch.Tensor  # (64,) f32 cv2-semantics ray votes at the peak


def _pool_sum(p: torch.Tensor, q: int) -> torch.Tensor:
    """(n, H, W) -> (n, H//q, W//q) sums of q x q cells, added in row-major
    cell order (the order XLA:CPU's reduce takes, so the f32 sums match)."""
    n, h, w = p.shape
    hc, wc = (h // q) * q, (w // q) * q
    r = p[:, :hc, :wc].reshape(n, hc // q, q, wc // q, q)
    acc = r[:, :, 0, :, 0]
    for i in range(q):
        for j in range(q):
            if i or j:
                acc = acc + r[:, :, i, :, j]
    return acc


class EdgePlanes(NamedTuple):
    edges: torch.Tensor  # (64, H, W) f32 0/1 Canny edges
    gxn: torch.Tensor  # (64, H, W) f32 unit gradient x (0 where flat)
    gyn: torch.Tensor  # (64, H, W) f32 unit gradient y
    planes_flat: torch.Tensor  # (64, k) bf16 pooled cos-2theta planes
    #   (2*Hq*Wq columns, zeros after them), the score matmul's right operand


@functools.lru_cache(maxsize=32)
def _zero_tail(n: int, width: int, device: torch.device) -> torch.Tensor:
    """A (n, width) bf16 zero block, made once per shape and device and only
    ever read: joined in edge_planes' one cat, the planes' zero tail costs
    no device op a step."""
    return torch.zeros((n, width), dtype=torch.bfloat16, device=device)


def edge_planes(
    gray: torch.Tensor, dims: ConvHoughDims, param1: int = 100, k: int = None
) -> EdgePlanes:
    """Canny edges, Sobel (reflect101) unit gradients, and the two
    cos-2theta planes sum-pooled to accumulator resolution, cast to bf16
    (round-to-nearest-even) before the flatten. ``k``, the plan basis's K
    (default: the planes' own 2*Hq*Wq), is the width of ``planes_flat``:
    the columns past the planes are zero."""
    n_sq = gray.shape[0]
    edges = canny(gray, max(param1 // 2, 1), param1,
                  hysteresis_rounds=dims.hysteresis_rounds)
    dx, dy = sobel3(gray, border="reflect101")
    gx = dx.float()
    gy = dy.float()
    mag2 = gx * gx + gy * gy  # exact: integers below 2^24
    inv = torch.where(mag2 > 0, torch.rsqrt(mag2.clamp(min=1e-12)), 0.0)
    e = edges.float()
    gxn = gx * inv
    gyn = gy * inv
    q = dims.downsample
    p_cos = e * fma(gxn, gxn, -(gyn * gyn))  # XLA:CPU's rounding of gxn²-gyn²
    p_sin = e * 2.0 * gxn * gyn
    parts = [
        (_pool_sum(p, q) if q > 1 else p).to(torch.bfloat16).reshape(n_sq, -1)
        for p in (p_cos, p_sin)
    ]
    tail = 0 if k is None else k - 2 * parts[0].shape[1]
    if tail < 0:
        raise ValueError(f"edge_planes: k = {k} is below the planes' {2 * parts[0].shape[1]}")
    if tail:
        parts.append(_zero_tail(n_sq, tail, gray.device))
    planes_flat = torch.cat(parts, dim=1)
    return EdgePlanes(e, gxn, gyn, planes_flat)


def find_circle(
    gray: torch.Tensor,
    plan: ConvHoughPlan,
    dims: ConvHoughDims,
    param1: int = 100,
    param2: int = 25,
) -> ConvCircle:
    """Best circle near each square's center. gray: (64, H, W) u8 pre-blurred.

    1. PROPOSE: the score matmul scores every (center, radius) of the
       union window; masked to each square's own cells (kvalid), the
       first-max argmax picks one candidate per square.
    2. VERIFY: an edge pixel p with unit gradient g votes for the proposed
       center c iff minR <= |p-c| <= maxR and |cross(c-p, g)| <= 2.5 px;
       found = votes > param2 (the exact backend's rule and threshold).
    """
    _, H, W = gray.shape
    q = dims.downsample
    e, gxn, gyn, planes_flat = edge_planes(gray, dims, param1, k=plan.basis.shape[1])

    score_m = score_matmul(plan.basis, planes_flat)  # (Mq, 64) f32
    flat = torch.where(plan.kvalid, score_m, -torch.inf)
    best = torch.argmax(flat, dim=0)  # the first maximal index on ties
    best_score = flat.amax(dim=0)
    code = plan.kept_code[best]
    Yu, Xu = dims.union_h, dims.union_w
    ri = code // (Yu * Xu)
    rest = code % (Yu * Xu)
    by = rest // Xu
    bx = rest % Xu
    # Accumulator cells back to full-resolution pixel coords (cell center).
    cy = ((dims.union_y0 + by).float() + 0.5) * q
    cx = ((dims.union_x0 + bx).float() + 0.5) * q
    radius = torch.round(plan.radii[ri]).to(torch.int32)

    ys = torch.arange(H, dtype=torch.float32, device=gray.device)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=gray.device)[None, None, :]
    dyc = ys - cy[:, None, None]
    dxc = xs - cx[:, None, None]
    dist = torch.sqrt(dyc * dyc + dxc * dxc)
    in_range = (dist >= plan.r_min[:, None, None]) & (dist <= plan.r_max[:, None, None])
    cross = fma(dxc, gyn, -(dyc * gxn)).abs()  # XLA:CPU's rounding
    votes = (e * in_range * (cross <= _VOTE_TOL)).sum(dim=(-2, -1))
    found = votes > param2
    return ConvCircle(
        found=found, cx=cx, cy=cy, radius=radius, score=best_score, votes=votes
    )
