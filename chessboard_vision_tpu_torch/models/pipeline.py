"""Frame -> per-square occupancy pipeline (conv Hough backend).

Counterpart of chessboard_vision_tpu.models.pipeline. One step turns a
planar BGR camera frame into 64 per-square ``StepOutputs``: gray ->
bilinear square resample -> 5x5 Gaussian -> piece cascade with delta
cache and 5-frame smoothing -> EMA change model. With ``with_enhancer``
the frame is first warped to a color board, enhanced (models/enhancer.py:
CLAHE and bilateral kernels) and grayscaled, and the squares are taken
from the board. The temporal state is an explicit ``PipelineState``:
``step(state, frame) -> (state, outputs)``.

Host <-> device traffic: ``step`` and ``step_many`` make one H2D copy each
(the frame or frame chunk, packed with the per-frame control flags) and
never wait on the device; the outputs stay on the device until
``outputs_to_numpy`` reads them back in one D2H copy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from chessboard_vision_tpu_torch.device import resolve_device
from chessboard_vision_tpu_torch.geometry import BoardGeometry
from chessboard_vision_tpu_torch.models import piece_detector as pd_model
from chessboard_vision_tpu_torch.models.enhancer import enhance_planar
from chessboard_vision_tpu_torch.ops import change as change_ops
from chessboard_vision_tpu_torch.ops import hough_conv as hough_conv_ops
from chessboard_vision_tpu_torch.ops import matmul_resample as mr
from chessboard_vision_tpu_torch.ops import piece as piece_ops
from chessboard_vision_tpu_torch.ops import warp as warp_ops
from chessboard_vision_tpu_torch.ops.color import planar_bgr2gray
from chessboard_vision_tpu_torch.ops.filters import gaussian_blur_valid
from chessboard_vision_tpu_torch.ops.layout import positions_to_mask


class PipelineState(NamedTuple):
    piece: pd_model.PieceState
    change: change_ops.ChangeModelState


class StepOutputs(NamedTuple):
    occupancy: torch.Tensor  # (64,) bool smoothed has_piece per square
    raw_occupancy: torch.Tensor  # (64,) bool
    visual_changes: torch.Tensor  # (64,) bool
    method: torch.Tensor  # (64,) i32
    confidence: torch.Tensor  # (64,) f32
    radius: torch.Tensor  # (64,) i32
    change_intensity: torch.Tensor  # (64,) i32
    change_pct: torch.Tensor  # (64,) f32
    change_z_peak: torch.Tensor  # (64,) f32
    center_mean: torch.Tensor  # (64,) f32 mean gray over the center disc
    corner_mean: torch.Tensor  # (64,) f32 mean gray over the corner regions
    profile_extent: torch.Tensor  # (64,) f32 ring-coverage size profile


_OUTPUT_DTYPES = (
    np.bool_, np.bool_, np.bool_, np.int32, np.float32, np.int32,
    np.int32, np.float32, np.float32, np.float32, np.float32, np.float32,
)


def outputs_to_numpy(out: StepOutputs) -> StepOutputs:
    """Device StepOutputs (any leading shape) -> host numpy, in ONE D2H copy:
    the 12 fields are packed bit for bit into one int32 tensor first."""
    packed = torch.stack(
        [
            f.view(torch.int32) if f.dtype == torch.float32 else f.to(torch.int32)
            for f in out
        ]
    ).cpu().numpy()
    return StepOutputs(
        *(
            packed[i].view(np.float32) if dt == np.float32 else packed[i].astype(dt)
            for i, dt in enumerate(_OUTPUT_DTYPES)
        )
    )


def state_from_numpy(tree, device="cuda") -> PipelineState:
    """A PipelineState-shaped tree of arrays (e.g. the JAX package's state,
    leaves through ``np.asarray``) -> the port's state on ``device`` (the
    card unless the caller asks for the CPU). Leaves are matched by field
    name."""
    device = resolve_device(device, "state_from_numpy")

    def conv(cls, node):
        return cls(
            **{
                name: torch.as_tensor(np.array(getattr(node, name)), device=device)
                for name in cls._fields
            }
        )

    return PipelineState(
        piece=conv(pd_model.PieceState, tree.piece),
        change=conv(change_ops.ChangeModelState, tree.change),
    )


def state_to_numpy(state: PipelineState) -> PipelineState:
    """The port's state -> the same tree with host numpy leaves."""
    return PipelineState(
        piece=pd_model.PieceState(*(x.cpu().numpy() for x in state.piece)),
        change=change_ops.ChangeModelState(*(x.cpu().numpy() for x in state.change)),
    )


class VisionPipeline:
    """Frame -> occupancy pipeline for one calibration geometry, on one device.

    Every geometry-derived constant (resample plans, masks, Hough basis) is
    built on the host and moved to ``device`` once, here. Recalibrating
    builds a new pipeline. ``device`` is the card unless the caller asks
    for the CPU; without a card, "cuda" raises.
    """

    def __init__(
        self,
        geometry: BoardGeometry,
        piece_settings: Optional[dict] = None,
        change_settings: Optional[dict] = None,
        hough_backend: str = "auto",
        with_enhancer: bool = False,
        enhancer_profile: Optional[dict] = None,
        detector_overrides: Optional[dict] = None,
        device="cuda",
    ):
        self.device = resolve_device(device, "VisionPipeline")
        if hough_backend == "auto":
            hough_backend = "conv"
        if hough_backend != "conv":
            raise NotImplementedError(
                f"hough_backend={hough_backend!r}: only 'conv' is ported "
                "(the exact backend is ROADMAP.md Queue A, A12)"
            )
        self.hough_backend = hough_backend
        self.geometry = geometry
        self.dg = warp_ops.DeviceGeometry.from_host(geometry, device=self.device)
        s = geometry.squares
        heights, widths = s.heights, s.widths
        self.H, self.W = int(heights.max()), int(widths.max())

        min_ratio, max_ratio = 0.20, 0.55
        if piece_settings:
            if "min_radius" in piece_settings:
                min_ratio = piece_settings["min_radius"] / 100.0
            if "max_radius" in piece_settings:
                max_ratio = piece_settings["max_radius"] / 100.0
        self.masks = piece_ops.PieceMasks.build(
            heights, widths, self.H, self.W, device=self.device
        )
        # Bounded hysteresis (2 rounds) on the conv path, as in the JAX package.
        self.conv_plan, self.conv_dims = hough_conv_ops.ConvHoughPlan.build(
            heights, widths, min_ratio=min_ratio, max_ratio=max_ratio,
            plane_h=self.H, plane_w=self.W, hysteresis_rounds=2, device=self.device,
        )
        self._pad = s.pad
        qx, qy = geometry.square_query_coords()
        self._mm_plan, self._mm_dims = mr.build_plan(
            qx, qy, geometry.src_h, geometry.src_w, device=self.device
        )

        # The enhanced path needs a COLOR board: the tile plan warps the
        # frame to 64 overlapping board tiles (the JAX package's plan, so
        # each tile's samples round as there), one gather assembles the
        # board, and the padded squares are gathered from the enhanced gray
        # board at the square maps' integer coordinates. (The JAX package
        # resamples with an integer-coordinate plan over the edge-padded
        # board, which reproduces exactly this gather.)
        self.with_enhancer = with_enhancer
        self.enhancer_profile = dict(enhancer_profile) if enhancer_profile else {}
        if with_enhancer:
            B = geometry.board_size
            tqx, tqy, starts, tile = geometry.board_tile_query_coords()
            self._tile_plan, self._tile_dims = mr.build_plan(
                tqx, tqy, geometry.src_h, geometry.src_w, device=self.device
            )
            self._tile_index = torch.as_tensor(
                mr.board_tile_index(starts, tile, B), device=self.device
            )
            self._ext_index = torch.as_tensor(
                s.iy.astype(np.int64) * B + s.ix, device=self.device
            )

        cs = change_settings or {}
        self.z_threshold = float(cs.get("z_threshold", 2.5))
        self.initial_variance = float(cs.get("initial_variance", 100.0))
        self.alpha = float(cs.get("alpha", 0.1))
        self.change_blur = int(cs.get("blur_kernel", 5))
        if self.change_blur % 2 == 0:
            raise ValueError(f"blur_kernel must be odd, got {self.change_blur}")
        if self.change_blur // 2 > self._pad:
            raise ValueError(
                f"blur_kernel {self.change_blur} needs geometry blur_pad >= "
                f"{self.change_blur // 2} (have {self._pad}); rebuild with "
                f"BoardGeometry.from_calibration(..., blur_pad={self.change_blur // 2})"
            )

        # Detector threshold overrides (the calibrator tools' seam).
        ov = detector_overrides or {}
        self._det_kwargs = {}
        if "hough_param1" in ov:
            self._det_kwargs["hough_param1"] = int(ov["hough_param1"])
        if "hough_param2" in ov:
            self._det_kwargs["hough_param2"] = int(ov["hough_param2"])
        if "center_diff_threshold" in ov:
            self._det_kwargs["center_diff_threshold"] = float(ov["center_diff_threshold"])

    # -- device functions ------------------------------------------------

    def preprocess(self, frame: torch.Tensor):
        """(3, Hf, Wf) planar u8 -> blurred gray squares (64, H, W) u8 for the
        piece cascade and for the change model (the same tensor unless the
        change model has its own blur kernel)."""
        if self.with_enhancer:
            board = mr.warp_board_color(frame, self._tile_plan, self._tile_dims, self._tile_index)
            gray_padded = self._enhanced_board_squares(board)
        else:
            gray_frame = planar_bgr2gray(frame)
            gray_padded = mr.resample_gray_u8(gray_frame, self._mm_plan, self._mm_dims)
        gray = gaussian_blur_valid(gray_padded, 5, pad=self._pad)
        if self.change_blur != 5:
            gray_cd = gaussian_blur_valid(gray_padded, self.change_blur, pad=self._pad)
        else:
            gray_cd = gray
        return gray, gray_cd

    def _enhanced_board_squares(self, board: torch.Tensor) -> torch.Tensor:
        """Warped color board (3, B, B) u8 -> enhanced padded gray squares
        (64, H+2p, W+2p) u8: enhance -> grayscale -> square extraction."""
        board = enhance_planar(board, self.enhancer_profile)
        return planar_bgr2gray(board).reshape(-1)[self._ext_index]

    def _step_impl(self, state, frame, s2c_mask, s2c_given, refresh_refs):
        gray, gray_cd = self.preprocess(frame)
        gray_flat = change_ops.flatten_pixels(gray)
        # Post-move forced re-reference, applied with this frame's gray.
        p = state.piece
        piece_in = p._replace(
            ref_gray=torch.where(refresh_refs, gray_flat, p.ref_gray),
            has_ref=p.has_ref | refresh_refs,
            has_cache=p.has_cache & ~refresh_refs,
        )
        piece_state, det = pd_model.detect_all(
            piece_in, gray, self.masks, s2c_mask, s2c_given,
            self.conv_plan, self.conv_dims,
            gray_flat=gray_flat, **self._det_kwargs,
        )
        gcd = change_ops.flatten_pixels(gray_cd)
        cdet = change_ops.detect(
            state.change, gcd, self.z_threshold, self.dg.sq_mask_flat, self.dg.sq_counts,
        )
        change_state = change_ops.update_references(
            state.change, gcd, self.alpha,
            torch.ones((gcd.shape[0],), dtype=torch.bool, device=gcd.device),
        )

        outputs = StepOutputs(
            occupancy=det.has_piece,
            raw_occupancy=det.raw_has_piece,
            visual_changes=det.visual_changes,
            method=det.method,
            confidence=det.confidence,
            radius=det.radius,
            change_intensity=cdet.intensity,
            change_pct=cdet.pct_changed,
            change_z_peak=cdet.z_peak,
            center_mean=det.center_mean,
            corner_mean=det.border_mean,
            profile_extent=det.extent,
        )
        return PipelineState(piece=piece_state, change=change_state), outputs

    def _upload(self, frames, s2c_mask: np.ndarray, flags) -> tuple:
        """One H2D copy: host frame(s) (HWC camera layout or planar) become
        planar u8 in one host buffer together with the (64,) square mask
        and the flags; the buffer is page-locked on CUDA, so the copy is
        asynchronous. Returns device views (planar frames, mask, flags)."""
        frames = np.asarray(frames, np.uint8)
        if frames.shape[-1] == 3:  # HWC camera layout -> planar view
            frames = np.moveaxis(frames, -1, -3)
        n = frames.size
        host = torch.empty(
            n + 64 + len(flags), dtype=torch.uint8,
            pin_memory=self.device.type == "cuda",
        )
        buf = host.numpy()
        buf[:n].reshape(frames.shape)[...] = frames
        buf[n : n + 64] = s2c_mask
        buf[n + 64 :] = flags
        t = host.to(self.device, non_blocking=True)
        return t[:n].view(frames.shape), t[n : n + 64].bool(), t[n + 64 :].bool()

    # -- host API --------------------------------------------------------

    def init_state(self) -> PipelineState:
        shape = (64, self.H, self.W)
        return PipelineState(
            piece=pd_model.init_state(shape, device=self.device),
            change=change_ops.init_state(shape, device=self.device),
        )

    def capture_reference(self, state: PipelineState, frame) -> PipelineState:
        """Set visual references from a frame (reference capture_reference,
        game_session.py:93-111) and calibrate the change model."""
        frame_dev, _, _ = self._upload(frame, np.zeros(64, bool), ())
        gray, gray_cd = self.preprocess(frame_dev)
        piece = pd_model.update_references(state.piece, gray)
        change = change_ops.calibrate(gray_cd, self.initial_variance)
        return PipelineState(piece=piece, change=change)

    def step(
        self,
        state: PipelineState,
        frame,
        squares_to_check=None,
        refresh_refs: bool = False,
    ):
        """Process one host frame: (H, W, 3) HWC or (3, H, W) planar BGR u8.
        squares_to_check: optional set of (file, rank) to force a fresh
        detection on; refresh_refs forces a visual re-reference from this
        frame first. Returns (state, StepOutputs on the device)."""
        given = squares_to_check is not None
        mask = positions_to_mask(squares_to_check) if given else np.zeros(64, bool)
        frame_dev, s2c_mask, flags = self._upload(frame, mask, (given, refresh_refs))
        return self._step_impl(state, frame_dev, s2c_mask, flags[0], flags[1])

    def step_many(
        self,
        state: PipelineState,
        frames,
        squares_to_check=None,
        refresh_first: bool = False,
    ):
        """Process a chunk of K host frames: (K, H, W, 3) or (K, 3, H, W) u8.

        One H2D copy for the chunk, a device-side loop of K steps with the
        same per-frame semantics as K sequential ``step`` calls, outputs
        stacked to (K, 64) on the device (one D2H via outputs_to_numpy).
        squares_to_check applies to every frame; refresh_first re-references
        from frame 0 only."""
        given = squares_to_check is not None
        mask = positions_to_mask(squares_to_check) if given else np.zeros(64, bool)
        frames_dev, s2c_mask, flags = self._upload(
            frames, mask, (given, refresh_first, False)
        )
        given_d, refresh_d, no_refresh = flags[0], flags[1], flags[2]
        outs = []
        for i in range(frames_dev.shape[0]):
            state, out = self._step_impl(
                state, frames_dev[i], s2c_mask, given_d, refresh_d if i == 0 else no_refresh
            )
            outs.append(out)
        return state, StepOutputs(*(torch.stack(f) for f in zip(*outs)))


def occupancy_to_set(occ) -> set:
    """(64,) bool (chess-index order) -> {(file, rank)} set."""
    if isinstance(occ, torch.Tensor):
        occ = occ.cpu().numpy()
    occ = np.asarray(occ)
    return {(sq % 8, sq // 8) for sq in range(64) if occ[sq]}
