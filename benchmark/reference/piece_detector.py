# Frozen copy of chessboard_vision_tpu_torch/models/piece_detector.py at commit 9f9af32, for the
# benchmark's plain reference: imports rewritten to this folder, nothing else
# changed unless a "reference:" comment says so.
"""Stateful piece detector: visual-delta gate, result cache, 5-frame smoothing.

Counterpart of chessboard_vision_tpu.models.piece_detector (reference
piece_detector.py detect_all_pieces :348-440). All 64 squares are detected
every call; the state semantics (which result is reported, when caches and
references update) follow the reference exactly. ``PieceDetectorModel`` is
the reference PieceDetector's host API over that state; the pipeline calls
the functional ``detect_all``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .device import resolve_device
from . import hough as hough_ops
from . import piece as piece_ops
from .layout import positions_to_mask

HISTORY = 5
MIN_PRESENCE = 0.6
CHANGE_THRESHOLD = 25  # mean-abs-diff gate (piece_detector.py:50)


class PieceState(NamedTuple):
    ref_gray: torch.Tensor  # (64, H*W) u8 visual reference (preprocessed), flat
    has_ref: torch.Tensor  # (64,) bool
    cache_has: torch.Tensor  # (64,) bool raw cached result
    cache_method: torch.Tensor  # (64,) i32
    cache_conf: torch.Tensor  # (64,) f32
    cache_cx: torch.Tensor  # (64,) f32
    cache_cy: torch.Tensor  # (64,) f32
    cache_radius: torch.Tensor  # (64,) i32
    has_cache: torch.Tensor  # (64,) bool
    hist: torch.Tensor  # (64, HISTORY) i32 sliding window of raw has_piece
    hist_len: torch.Tensor  # (64,) i32


def init_state(shape=(64, 77, 77), device="cuda") -> PieceState:
    device = resolve_device(device, "piece_detector.init_state")
    n, p = shape[0], 1
    for d in shape[1:]:
        p *= int(d)

    def z(shape_, dtype):
        return torch.zeros(shape_, dtype=dtype, device=device)

    return PieceState(
        ref_gray=z((n, p), torch.uint8),
        has_ref=z((n,), torch.bool),
        cache_has=z((n,), torch.bool),
        cache_method=z((n,), torch.int32),
        cache_conf=z((n,), torch.float32),
        cache_cx=z((n,), torch.float32),
        cache_cy=z((n,), torch.float32),
        cache_radius=z((n,), torch.int32),
        has_cache=z((n,), torch.bool),
        hist=z((n, HISTORY), torch.int32),
        hist_len=z((n,), torch.int32),
    )


class DetectAllOutputs(NamedTuple):
    has_piece: torch.Tensor  # (64,) bool smoothed (reported) occupancy
    raw_has_piece: torch.Tensor  # (64,) bool this frame's raw/cached result
    visual_changes: torch.Tensor  # (64,) bool delta vs visual reference
    method: torch.Tensor  # (64,) i32
    confidence: torch.Tensor  # (64,) f32
    center_x: torch.Tensor  # (64,) f32
    center_y: torch.Tensor  # (64,) f32
    radius: torch.Tensor  # (64,) i32
    center_mean: torch.Tensor  # (64,) f32 this frame's center-disk mean
    border_mean: torch.Tensor  # (64,) f32 this frame's corner-patch mean
    extent: torch.Tensor  # (64,) f32 this frame's ring-coverage profile


def _mean_diff_exceeds(gray_flat, ref_flat, counts, valid_flat, threshold):
    """mean(|gray - ref|) > threshold as an integer-exact comparison. The
    u8 operands are widened to int32 first: u8 subtraction would wrap."""
    d = (gray_flat.to(torch.int32) - ref_flat.to(torch.int32)).abs()
    s = (d * valid_flat).sum(dim=-1)
    return s > threshold * counts


def _push_history(hist, hist_len, value):
    """Sliding-window append (list append + pop(0) at size HISTORY)."""
    full = hist_len >= HISTORY
    shifted = torch.cat([hist[:, 1:], value[:, None]], dim=1)
    pos = torch.arange(HISTORY, device=hist.device)[None, :] == hist_len.clamp(max=HISTORY - 1)[:, None]
    appended = torch.where(pos, value[:, None], hist)
    new_hist = torch.where(full[:, None], shifted, appended)
    new_len = (hist_len + 1).clamp(max=HISTORY)
    return new_hist, new_len


def _stable_detection(hist, hist_len):
    """<3 frames: last value; else presence >= 60% (piece_detector.py:111-122)."""
    idx = (hist_len - 1).clamp(min=0).long()
    last = hist.gather(1, idx[:, None])[:, 0] > 0
    valid = torch.arange(HISTORY, device=hist.device)[None, :] < hist_len[:, None]
    presence = (hist * valid).sum(dim=-1).float() / hist_len.clamp(min=1).float()
    return torch.where(hist_len < 3, last, presence >= MIN_PRESENCE)


def detect_all(
    state: PieceState,
    gray: torch.Tensor,
    masks: piece_ops.PieceMasks,
    s2c_mask: torch.Tensor,  # (n,) bool
    s2c_given: torch.Tensor,  # () or (n,) bool: whether squares_to_check was provided
    conv_plan=None,
    conv_dims=None,
    hough_param1: int = 100,
    hough_param2: int = 25,
    center_diff_threshold: float = 40.0,
    gray_flat: Optional[torch.Tensor] = None,
    hough_backend: str = "conv",
    params=None,
    bounds=None,
    use_smoothing: bool = True,
    use_delta: bool = True,
) -> Tuple[PieceState, DetectAllOutputs]:
    """One detect_all_pieces step. gray: (64, H, W) u8 preprocessed
    squares; gray_flat: optional (64, H*W) view of the same gray. The Hough
    backend and its constants go to ops/piece.detect_pieces:
    conv_plan/conv_dims for 'conv', params/bounds (its hough_params and
    hough_bounds) for 'exact'.

    ``use_delta=False`` turns the delta gate off for the squares of
    ``s2c_mask`` when ``s2c_given``: only they are detected afresh, the
    rest report their cache. ``use_smoothing=False`` reports the raw
    result of this frame instead of the 5-frame vote (the stateless
    convenience calls of api.py use both)."""
    if gray_flat is None:
        gray_flat = gray.reshape(gray.shape[0], -1)
    changed = _mean_diff_exceeds(
        gray_flat, state.ref_gray, masks.counts, masks.valid_flat, CHANGE_THRESHOLD
    ) | ~state.has_ref
    visual_changes = changed

    forced = s2c_given & s2c_mask
    delta_path = ~s2c_given | use_delta
    should = forced | (~forced & delta_path & (~state.has_cache | changed))
    use_fresh = should | ~state.has_cache

    fresh = piece_ops.detect_pieces(
        gray, masks, conv_plan, conv_dims,
        hough_param1=hough_param1, hough_param2=hough_param2,
        center_diff_threshold=center_diff_threshold,
        hough_backend=hough_backend, hough_params=params, hough_bounds=bounds,
    )

    raw_has = torch.where(use_fresh, fresh.has_piece, state.cache_has)
    raw_method = torch.where(use_fresh, fresh.method, state.cache_method)
    raw_conf = torch.where(use_fresh, fresh.confidence, state.cache_conf)
    raw_cx = torch.where(use_fresh, fresh.center_x, state.cache_cx)
    raw_cy = torch.where(use_fresh, fresh.center_y, state.cache_cy)
    raw_radius = torch.where(use_fresh, fresh.radius, state.cache_radius)

    hist, hist_len = _push_history(state.hist, state.hist_len, raw_has.to(torch.int32))

    if use_smoothing:
        reported = _stable_detection(hist, hist_len)
        ref_update = should & (raw_has == reported)
    else:
        reported = raw_has
        ref_update = should
    new_state = PieceState(
        ref_gray=torch.where(ref_update[:, None], gray_flat, state.ref_gray),
        has_ref=state.has_ref | ref_update,
        cache_has=raw_has,
        cache_method=raw_method,
        cache_conf=raw_conf,
        cache_cx=raw_cx,
        cache_cy=raw_cy,
        cache_radius=raw_radius,
        has_cache=state.has_cache | use_fresh,
        hist=hist,
        hist_len=hist_len,
    )
    outputs = DetectAllOutputs(
        has_piece=reported,
        raw_has_piece=raw_has,
        visual_changes=visual_changes,
        method=raw_method,
        confidence=raw_conf,
        center_x=raw_cx,
        center_y=raw_cy,
        radius=raw_radius,
        center_mean=fresh.center_mean,
        border_mean=fresh.border_mean,
        extent=fresh.extent,
    )
    return new_state, outputs


def update_references(state: PieceState, gray: torch.Tensor) -> PieceState:
    """Force-refresh all visual references and clear the result cache
    (reference update_references, piece_detector.py:447-453)."""
    flat = gray if gray.dim() == 2 else gray.reshape(gray.shape[0], -1)
    return state._replace(
        ref_gray=flat,
        has_ref=torch.ones_like(state.has_ref),
        has_cache=torch.zeros_like(state.has_cache),
    )


class PieceDetectorModel:
    """The reference PieceDetector's API (dict-of-squares host calls) over
    the device state, on ``device`` (the card unless the caller asks for
    the CPU), with the exact Hough backend, as the JAX package's model
    (its ``detect_all`` default). ``gray`` arguments are (64, H, W) u8
    preprocessed squares in chess-index order: a host array or a tensor."""

    def __init__(self, heights, widths, settings: Optional[dict] = None, device="cuda"):
        heights, widths = np.asarray(heights), np.asarray(widths)
        min_ratio, max_ratio = 0.20, 0.55
        if settings:
            if "min_radius" in settings:
                min_ratio = settings["min_radius"] / 100.0
            if "max_radius" in settings:
                max_ratio = settings["max_radius"] / 100.0
        self.device = resolve_device(device, "PieceDetectorModel")
        H, W = int(heights.max()), int(widths.max())
        self.masks = piece_ops.PieceMasks.build(heights, widths, H, W, device=self.device)
        self.params, self.bounds = hough_ops.HoughParams.from_geometry(
            heights, widths, min_ratio=min_ratio, max_ratio=max_ratio, device=self.device)
        self.state = init_state((64, H, W), device=self.device)

    def _gray(self, gray) -> torch.Tensor:
        return torch.as_tensor(gray, device=self.device)

    def detect_all_pieces(self, gray, squares_to_check=None, use_smoothing=True,
                          use_delta=True) -> DetectAllOutputs:
        """One detect_all step on the model's state (``detect_all``)."""
        given = squares_to_check is not None
        mask = positions_to_mask(squares_to_check) if given else np.zeros(64, bool)
        self.state, out = detect_all(
            self.state, self._gray(gray), self.masks,
            torch.as_tensor(mask, device=self.device), torch.tensor(given, device=self.device),
            hough_backend="exact", params=self.params, bounds=self.bounds,
            use_smoothing=use_smoothing, use_delta=use_delta,
        )
        return out

    def update_references(self, gray):
        self.state = update_references(self.state, self._gray(gray))

    def calibrate_reference(self, gray):
        """Set references AND prime the result cache from a fresh detection
        (reference calibrate_reference, piece_detector.py:70-80)."""
        gray = self._gray(gray)
        fresh = piece_ops.detect_pieces(gray, self.masks, hough_backend="exact",
                                        hough_params=self.params, hough_bounds=self.bounds)
        self.state = self.state._replace(
            ref_gray=gray.reshape(gray.shape[0], -1),
            has_ref=torch.ones_like(self.state.has_ref),
            cache_has=fresh.has_piece,
            cache_method=fresh.method,
            cache_conf=fresh.confidence,
            cache_cx=fresh.center_x,
            cache_cy=fresh.center_y,
            cache_radius=fresh.radius,
            has_cache=torch.ones_like(self.state.has_cache),
        )

    def get_occupied_squares(self, gray, use_smoothing=True) -> set:
        """Set of occupied (file, rank) tuples (piece_detector.py:442-445)."""
        has = self.detect_all_pieces(gray, use_smoothing=use_smoothing).has_piece.cpu().numpy()
        return {(sq % 8, sq // 8) for sq in range(64) if has[sq]}
