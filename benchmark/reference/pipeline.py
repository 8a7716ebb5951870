"""The plain reference of the vision step, for N boards on one device.

A frozen copy of the parts of chessboard_vision_tpu_torch/models/pipeline.py
(``VisionPipeline``: the conv Hough constants, the planar preprocess of a
host HWC frame, ``blur``, ``_step_core``, ``init_state``, ``_capture_core``)
and of chessboard_vision_tpu_torch/parallel/multistream.py (``_tile``,
``_slot_consts``: the stream-folded core with per-rig resample plans) at
commit 9f9af32 that the benchmark's two entries drive, with the default
settings of a checkout that holds no settings files. The Hough score matmul
is plain (score_matmul.py), and every constant is worked out again here from
the calibration corners the benchmark made.

``resample_dtype`` below float32 is the benchmark's lower-precision control:
the frame-to-square resample's taps and lerps in that dtype.

The reference of a configuration that names none (compare.py): it replays
the ``pipeline`` settings of ``IMPLEMENTS`` and no others.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import change as change_ops
from . import hough_conv as hough_conv_ops
from . import matmul_resample as mr
from . import piece as piece_ops
from . import piece_detector as pd_model
from .color import planar_bgr2gray
from .filters import gaussian_blur_valid
from .geometry import BoardGeometry
from .warp import DeviceGeometry


IMPLEMENTS = {"hough_backend": "conv", "use_enhancer": False}


class StepOutputs(NamedTuple):
    occupancy: torch.Tensor  # (n,) bool smoothed has_piece per square
    raw_occupancy: torch.Tensor  # (n,) bool
    visual_changes: torch.Tensor  # (n,) bool
    method: torch.Tensor  # (n,) i32
    confidence: torch.Tensor  # (n,) f32
    radius: torch.Tensor  # (n,) i32
    change_intensity: torch.Tensor  # (n,) i32
    change_pct: torch.Tensor  # (n,) f32
    change_z_peak: torch.Tensor  # (n,) f32
    center_mean: torch.Tensor  # (n,) f32
    corner_mean: torch.Tensor  # (n,) f32
    profile_extent: torch.Tensor  # (n,) f32


class PipelineState(NamedTuple):
    piece: pd_model.PieceState
    change: change_ops.ChangeModelState


def _tile(x, n: int, last: bool = False):
    """A per-square constant of 64 squares -> of n streams, stream-major."""
    if isinstance(x, tuple):
        return x * n
    reps = [1] * x.dim()
    reps[-1 if last else 0] = n
    return x.repeat(*reps)


class ReferencePipeline:
    """The vision step of ``len(geometries)`` boards, folded to n*64 squares.
    Every geometry shares the grid structure; corners may differ."""

    CHANGE_Z, CHANGE_VAR, CHANGE_ALPHA = 2.5, 100.0, 0.1  # the change model's defaults

    def __init__(self, geometries: Sequence[BoardGeometry], device,
                 resample_dtype: torch.dtype = torch.float32):
        self.device = torch.device(device)
        self.n = len(geometries)
        self.resample_dtype = resample_dtype
        base = geometries[0]
        s = base.squares
        heights, widths = s.heights, s.widths
        self.H, self.W = int(heights.max()), int(widths.max())
        self.pad = s.pad
        plan, dims = hough_conv_ops.ConvHoughPlan.build(
            heights, widths, min_ratio=0.20, max_ratio=0.55,
            plane_h=self.H, plane_w=self.W, hysteresis_rounds=2, device=self.device,
        )
        dg = DeviceGeometry.from_host(base, device=self.device)
        masks = piece_ops.PieceMasks.build(heights, widths, self.H, self.W, device=self.device)
        n = self.n

        def t(x):
            return _tile(x, n)

        self.dg = dg._replace(sq_mask=t(dg.sq_mask), sq_mask_flat=t(dg.sq_mask_flat),
                              sq_counts=t(dg.sq_counts), sq_heights=t(dg.sq_heights),
                              sq_widths=t(dg.sq_widths))
        self.masks = piece_ops.PieceMasks(*map(t, masks))
        self.conv_plan = plan._replace(
            r_valid=t(plan.r_valid), r_min=t(plan.r_min), r_max=t(plan.r_max),
            win_offset_y=t(plan.win_offset_y), win_offset_x=t(plan.win_offset_x),
            win_mask=_tile(plan.win_mask, n, last=True), kvalid=_tile(plan.kvalid, n, last=True),
        )
        self.conv_dims = dims._replace(woy=t(dims.woy), wox=t(dims.wox))
        self.plans = [mr.build_plan(*g.square_query_coords(), g.src_h, g.src_w, device=self.device)
                      for g in geometries]

    def squares(self, frames: torch.Tensor) -> torch.Tensor:
        """(n, Hf, Wf, 3) HWC u8 frames -> (n*64, H, W) blurred gray squares."""
        planar = frames.to(self.device).movedim(-1, -3)
        gray = planar_bgr2gray(planar)
        padded = torch.cat([mr.resample_gray_u8(gray[i], plan, dims, self.resample_dtype)
                            for i, (plan, dims) in enumerate(self.plans)])
        return gaussian_blur_valid(padded, 5, pad=self.pad)

    def init_state(self) -> PipelineState:
        shape = (self.n * 64, self.H, self.W)
        return PipelineState(piece=pd_model.init_state(shape, device=self.device),
                             change=change_ops.init_state(shape, device=self.device))

    def capture(self, state: PipelineState, frames: torch.Tensor) -> PipelineState:
        gray = self.squares(frames)
        return PipelineState(piece=pd_model.update_references(state.piece, gray),
                             change=change_ops.calibrate(gray, self.CHANGE_VAR))

    def step(self, state: PipelineState, frames: torch.Tensor, s2c: np.ndarray,
             given: np.ndarray, refresh: np.ndarray):
        """One step of every board: s2c (n, 64) bool, given and refresh (n,)
        bool. Returns (state, StepOutputs with leaves (n*64,))."""
        gray = self.squares(frames)
        flags = torch.from_numpy(np.concatenate([
            np.asarray(s2c, bool).reshape(-1), np.repeat(np.asarray(given, bool), 64),
            np.repeat(np.asarray(refresh, bool), 64)])).to(self.device)
        m = self.n * 64
        s2c_mask, s2c_given, refresh_refs = flags[:m], flags[m:2 * m], flags[2 * m:]
        gray_flat = change_ops.flatten_pixels(gray)
        p = state.piece
        piece_in = p._replace(
            ref_gray=torch.where(refresh_refs[:, None], gray_flat, p.ref_gray),
            has_ref=p.has_ref | refresh_refs,
            has_cache=p.has_cache & ~refresh_refs,
        )
        piece_state, det = pd_model.detect_all(
            piece_in, gray, self.masks, s2c_mask, s2c_given, self.conv_plan, self.conv_dims,
            gray_flat=gray_flat, hough_backend="conv",
        )
        cdet = change_ops.detect(state.change, gray_flat, self.CHANGE_Z,
                                 self.dg.sq_mask_flat, self.dg.sq_counts)
        change_state = change_ops.update_references(
            state.change, gray_flat, self.CHANGE_ALPHA,
            torch.ones((gray_flat.shape[0],), dtype=torch.bool, device=gray_flat.device),
        )
        out = StepOutputs(
            occupancy=det.has_piece, raw_occupancy=det.raw_has_piece,
            visual_changes=det.visual_changes, method=det.method,
            confidence=det.confidence, radius=det.radius,
            change_intensity=cdet.intensity, change_pct=cdet.pct_changed,
            change_z_peak=cdet.z_peak, center_mean=det.center_mean,
            corner_mean=det.border_mean, profile_extent=det.extent,
        )
        return PipelineState(piece=piece_state, change=change_state), out


def build(config: dict, geometries: Sequence[BoardGeometry], device,
          resample_dtype: torch.dtype) -> ReferencePipeline:
    return ReferencePipeline(geometries, device, resample_dtype=resample_dtype)
