"""Canny edge detection, bit-exact vs cv2.Canny (L1 magnitude, aperture 3).

Sobel-3 with replicate border, direction-quantized non-maximum suppression
with OpenCV's exact >/>= tie rules and its tan(22.5) fixed-point constant,
then 8-connected hysteresis. A hysteresis step is the JAX package's
``edges | (dilate3(edges) & weak)``; since the edges start as the strong
pixels and stay within cand = strong | weak, that is
``dilate3(edges) & cand``. As in the JAX package, the steps run on
bitplanes: the N images' bool maps are packed b = min(N, 32) to an
integer word, so a step is a few shifted ORs over (ceil(N/b), H, W) words,
bit-identical to the per-image maps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from chessboard_vision_tpu_torch.ops.filters import sobel3

_TG22 = 13573  # tan(22.5 deg) * 2^15, OpenCV's fixed-point constant
_MAX_ITERS = 256  # default dilation cap of the exact fixpoint, as in the JAX package
# The exact fixpoint runs its dilations in blocks and reads one "changed"
# flag back to the host after each block: _FIRST_BLOCK dilations, then each
# block _GROWTH times the last, the total capped at max_iters. Dilations past
# the fixpoint change nothing, so every schedule that stops at the fixpoint
# or at the cap gives the JAX package's edges (it checks every 4 dilations).
_FIRST_BLOCK, _GROWTH = 8, 2


def _shift2(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift a (..., H, W) tensor by (dy, dx), filling vacated cells with 0."""
    h, w = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0)))
    pb, pr = max(-dy, 0), max(-dx, 0)
    return xp[..., pb : pb + h, pr : pr + w]


def _pack_bits(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool -> (ceil(N/b), H, W) int64 words of b = min(N, 32)
    bits, image s in bit s % b of word s // b (padding images are 0, inert
    under dilation; fewer than 32 images take no padding)."""
    n, h, w = x.shape
    b = min(n, 32)
    k = -(-n // b)
    xp = F.pad(x.to(torch.int64), (0, 0, 0, 0, 0, k * b - n)).reshape(k, b, h, w)
    sh = torch.arange(b, device=x.device, dtype=torch.int64).reshape(1, b, 1, 1)
    return (xp << sh).sum(dim=1)  # disjoint bits: the sum is an OR


def _unpack_bits(p: torch.Tensor, n: int) -> torch.Tensor:
    """(K, H, W) words of _pack_bits -> (n, H, W) bool."""
    k, h, w = p.shape
    b = min(n, 32)
    sh = torch.arange(b, device=p.device, dtype=torch.int64).reshape(1, b, 1, 1)
    return ((p[:, None] >> sh) & 1).reshape(k * b, h, w)[:n].bool()


def _grow(edges: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """One hysteresis step on packed words: the 8-connected dilation of
    ``edges`` within ``cand``."""
    h, w = edges.shape[-2], edges.shape[-1]
    xp = F.pad(edges, (1, 1, 1, 1))
    v = xp[..., 0:h, :] | xp[..., 1 : h + 1, :] | xp[..., 2 : h + 2, :]
    return (v[..., 0:w] | v[..., 1 : w + 1] | v[..., 2 : w + 2]) & cand


def canny(img: torch.Tensor, low: int, high: int, max_iters: int = _MAX_ITERS,
          hysteresis_rounds: int = -1) -> torch.Tensor:
    """cv2.Canny(img, low, high) for u8 (..., H, W) images -> bool edges.

    hysteresis_rounds: -1 runs the exact fixpoint, at most ``max_iters``
    dilations (its convergence test reads a flag back to the host once per
    block of dilations, each read counted in ``canny.host_syncs``). It is
    bit-exact vs cv2, which has no cap, where no weak chain is longer than
    the cap: the Hough path keeps the JAX package's 256 (ample inside a
    square), the corner detector passes H * W for a whole frame. k >= 0 runs
    exactly k rounds of 4 dilations with no host sync (the pipeline's conv
    Hough path uses 2): weak pixels further than 4k steps from a strong
    pixel are dropped.
    """
    dx, dy = sobel3(img)
    mag = dx.abs() + dy.abs()

    def nb(dy_, dx_):
        return _shift2(mag, -dy_, -dx_)  # value of neighbor at (+dy_, +dx_)

    ax = dx.abs()
    ay = dy.abs() << 15
    tg22x = ax * _TG22
    tg67x = tg22x + (ax << 16)
    horiz = ay < tg22x
    vert = (~horiz) & (ay > tg67x)
    s_pos = (dx ^ dy) >= 0  # gradient signs agree -> main diagonal

    keep_h = (mag > nb(0, -1)) & (mag >= nb(0, 1))
    keep_v = (mag > nb(-1, 0)) & (mag >= nb(1, 0))
    keep_d_pos = (mag > nb(-1, -1)) & (mag > nb(1, 1))
    keep_d_neg = (mag > nb(-1, 1)) & (mag > nb(1, -1))
    keep_d = torch.where(s_pos, keep_d_pos, keep_d_neg)
    keep = torch.where(horiz, keep_h, torch.where(vert, keep_v, keep_d))

    cand = (mag > low) & keep
    shape = cand.shape
    cand = cand.reshape((-1,) + shape[-2:])
    n = cand.shape[0]
    edges = _pack_bits(cand & (mag > high).reshape(cand.shape))
    cand = _pack_bits(cand)
    if hysteresis_rounds >= 0:
        for _ in range(4 * hysteresis_rounds):
            edges = _grow(edges, cand)
        return _unpack_bits(edges, n).reshape(shape)

    done, block = 0, _FIRST_BLOCK
    while True:
        new = edges
        for _ in range(min(block, max_iters - done)):
            new = _grow(new, cand)
        done += min(block, max_iters - done)
        if done == max_iters:
            break
        canny.host_syncs += 1
        if torch.equal(new, edges):  # a block changed nothing: the fixpoint
            break
        edges, block = new, block * _GROWTH
    return _unpack_bits(new, n).reshape(shape)


canny.host_syncs = 0
