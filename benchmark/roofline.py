"""Published peaks of one NVIDIA H100 and the work of the port's kernels,
counted from their logical shapes.

The peaks and ``bound`` are copied from chip_smoke.py at commit 9f9af32
(NVIDIA's data sheet, SXM part, dense rates at the 700 W limit). The Hough
score matmul (B1) is counted from the configuration's own conv Hough plan,
which ``b1_shape`` builds with the benchmark's plain reference: an M x K bf16
ring basis (M its kept rows, the (r, y, x) cells some square accepts, without
the zero rows the plan pads them with to a multiple of 256, a tile size of
the TPU kernel; K the unpadded 2 * Hq * Wq pooled plane columns) against K x N bf16 planes, N = 64 a board, into M x N
f32 scores. Each operand counts once as read, the scores once as written,
and 2 * M * N * K operations, whatever kernel computes it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS, F32_FLOPS = 989e12, 67e12


def bound(nbytes: float, flops: float, flops_per_s: float):
    """Least seconds for the work: bytes at the memory rate or operations at
    the peak rate of their type, whichever is larger, and which it was."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def b1_bound(m: int, n: int, k: int):
    """B1's least seconds at (M, N, K), and whether bytes or operations set it."""
    return bound(2 * m * k + 2 * n * k + 4 * m * n, 2 * m * n * k, BF16_FLOPS)


def b1_shape(frame_size, boards: int):
    """(M, N, K) of one B1 call of a configuration: its frame size (h, w) gives
    the warped board and the squares, as the calibration does."""
    from .reference.geometry import linear_grid_lines, build_square_maps
    from .reference.hough_conv import ConvHoughPlan

    bs = min(frame_size) - 100
    grid = linear_grid_lines(bs)
    sq = build_square_maps(grid, grid, pad=2)
    h, w = int(sq.heights.max()), int(sq.widths.max())
    plan, dims = ConvHoughPlan.build(sq.heights, sq.widths, plane_h=h, plane_w=w,
                                     hysteresis_rounds=2, device="cpu", k_align=1)
    q = dims.downsample
    k = 2 * (h // q) * (w // q)
    if plan.basis.shape[1] != k:
        raise ValueError(f"the plan's K {plan.basis.shape[1]} is not 2 * Hq * Wq = {k}")
    kept = int(plan.kvalid.any(dim=1).sum())  # the padding rows are valid for no square
    return kept, 64 * int(boards), k

