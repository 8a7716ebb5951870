# Frozen copy of chessboard_vision_tpu_torch/ops/change.py at commit 9f9af32, for the
# benchmark's plain reference: imports rewritten to this folder, nothing else
# changed unless a "reference:" comment says so.
"""Per-square change detection: EMA background model + z-scores.

Counterpart of chessboard_vision_tpu.ops.change (reference
change_detector.py:67-201). State is flat per square, (64, H*W).
Percent-changed thresholds compare integer counts (count*100 vs
threshold*total), exactly equivalent to the reference's float compare.

Intensity codes: 0 = below 5% (ignored), 1 = LEVE, 2 = PARCIAL, 3 = TOTAL.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device
from .xla_rounding import fma

INTENSITY_NONE, INTENSITY_LEVE, INTENSITY_PARCIAL, INTENSITY_TOTAL = 0, 1, 2, 3
INTENSITY_NAMES = ["NONE", "LEVE", "PARCIAL", "TOTAL"]


class ChangeModelState(NamedTuple):
    means: torch.Tensor  # (64, P) f32, P = H*W
    variances: torch.Tensor  # (64, P) f32
    calibrated: torch.Tensor  # (64,) bool


def flatten_pixels(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H*W); already-flat inputs pass through."""
    return x.reshape(x.shape[:-2] + (-1,)) if x.dim() >= 3 else x


def init_state(shape=(64, 77, 77), device="cuda") -> ChangeModelState:
    device = resolve_device(device, "change.init_state")
    n, p = shape[0], 1
    for d in shape[1:]:
        p *= int(d)
    return ChangeModelState(
        means=torch.zeros((n, p), dtype=torch.float32, device=device),
        variances=torch.zeros((n, p), dtype=torch.float32, device=device),
        calibrated=torch.zeros((n,), dtype=torch.bool, device=device),
    )


def calibrate(gray: torch.Tensor, initial_variance: float) -> ChangeModelState:
    """Initialize the model from preprocessed (blurred gray) squares."""
    g = flatten_pixels(gray).float()
    return ChangeModelState(
        means=g,
        variances=torch.full_like(g, initial_variance),
        calibrated=torch.ones((g.shape[0],), dtype=torch.bool, device=g.device),
    )


def update_references(
    state: ChangeModelState,
    gray: torch.Tensor,
    alpha: float,
    update_mask: torch.Tensor,
) -> ChangeModelState:
    """EMA update of mean/variance on squares where update_mask is True:
    new_mean = (1-a)*m + a*x; new_var = max((1-a)*v + a*(x-new_mean)^2, 10).

    Each ``(1-a)*y + a*z`` rounds as XLA:CPU's contraction of the JAX
    form does (ops/xla_rounding.py)."""
    a32 = np.float32(alpha)
    a, one_m_a = float(a32), float(np.float32(1.0) - a32)  # f32 values
    g = flatten_pixels(gray).float()
    new_mean = fma(state.means, one_m_a, a * g)
    diff = g - new_mean
    new_var = fma(state.variances, one_m_a, a * (diff * diff)).clamp(min=10.0)
    m = update_mask.reshape(-1, 1)
    return ChangeModelState(
        means=torch.where(m, new_mean, state.means),
        variances=torch.where(m, new_var, state.variances),
        calibrated=state.calibrated,
    )


class ChangeDetections(NamedTuple):
    z_peak: torch.Tensor  # (64,) f32 peak z-score per square
    changed_counts: torch.Tensor  # (64,) i32 pixels above z threshold
    pct_changed: torch.Tensor  # (64,) f32
    intensity: torch.Tensor  # (64,) i32 code (0..3)
    significant: torch.Tensor  # (64,) bool  (pct >= 5%)


def detect(
    state: ChangeModelState,
    gray: torch.Tensor,
    z_threshold: float,
    valid_mask: torch.Tensor,
    counts: torch.Tensor,
) -> ChangeDetections:
    """Z-score change detection over all squares at once:
    z = |x - mean| / sqrt(var); changed where z > threshold; intensity from
    percent-changed with integer-exact threshold comparisons. An
    uncalibrated square reports no change."""
    g = flatten_pixels(gray).float()
    valid_mask = flatten_pixels(valid_mask)
    std = torch.sqrt(state.variances.clamp(min=1e-12))
    z = torch.where(state.calibrated[:, None], (g - state.means).abs() / std, 0.0)
    changed = (z > z_threshold) & valid_mask
    ccount = changed.sum(dim=-1, dtype=torch.int32)
    z_peak = torch.where(valid_mask, z, -torch.inf).amax(dim=-1)
    total = counts.to(torch.int32)
    pct = ccount.float() * 100.0 / total.float()

    c100 = ccount * 100
    significant = c100 >= 5 * total  # pct >= 5
    total_i = c100 > 75 * total  # pct > 75
    parcial = c100 > 15 * total  # pct > 15
    intensity = torch.where(
        total_i,
        INTENSITY_TOTAL,
        torch.where(parcial, INTENSITY_PARCIAL, INTENSITY_LEVE),
    )
    intensity = torch.where(significant, intensity, INTENSITY_NONE).to(torch.int32)
    return ChangeDetections(
        z_peak=z_peak,
        changed_counts=ccount,
        pct_changed=pct,
        intensity=intensity,
        significant=significant,
    )


def classify_hand_pattern(intensity: torch.Tensor, focus_mask: torch.Tensor):
    """Hand-vs-move heuristic on the intensity codes (reference
    classify_hand_pattern, change_detector.py:169-201): >=2 TOTAL squares
    or >2 changed squares -> hand; exactly 2 candidates -> move.
    Returns (is_hand, is_move, candidate_mask)."""
    active = (intensity > 0) & focus_mask
    n_active = active.sum()
    n_total = ((intensity == INTENSITY_TOTAL) & focus_mask).sum()
    is_hand = (n_total >= 2) | (n_active >= 4) | (n_active > 2)
    is_move = (~is_hand) & (n_active == 2)
    return is_hand, is_move, active
