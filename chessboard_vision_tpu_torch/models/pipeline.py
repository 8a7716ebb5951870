"""Frame -> per-square occupancy pipeline.

Counterpart of chessboard_vision_tpu.models.pipeline. One step turns a BGR
camera frame into 64 per-square ``StepOutputs``: squares -> 5x5 Gaussian ->
piece cascade with delta cache and 5-frame smoothing -> EMA change model.
The squares come by the frame's layout, as in the JAX package's
``_preprocess``: a planar (3, H, W) frame is grayscaled and resampled
(ops/matmul_resample.py); an HWC (H, W, 3) frame is warped to the board by
gather (ops/warp.py), its squares extracted and grayscaled. With
``with_enhancer`` the color board (tile plan for planar frames, the gather
warp for HWC) is enhanced (models/enhancer.py: CLAHE and bilateral kernels)
and grayscaled first, and the squares are taken from it. The host API
routes frames as the JAX package's does: its ``step`` turns a host (numpy)
HWC camera frame planar, so here a numpy HWC frame is taken planar too (the
card transposes the uploaded bytes), while a tensor keeps its layout, as a
JAX device array does: an HWC tensor takes the gather warp. The temporal
state is an explicit ``PipelineState``: ``step(state, frame) -> (state,
outputs)``.

Hough backends: ``conv`` (the score matmul, kernel B1) and ``exact`` (the
cv2-faithful voting transform, ops/hough.py). ``auto`` picks ``exact`` on
the CPU and ``conv`` on the card, as the JAX package picks ``exact`` off
the accelerator and ``conv`` on it.

Host <-> device traffic: ``step`` and ``step_many`` make one H2D copy each
(a host frame or frame chunk as its bytes are, packed with the per-frame
control flags; of a tensor, the flags alone); the outputs stay on the
device until ``outputs_to_numpy`` reads them back in one D2H copy. Only
the exact backend waits on the device within a step: its Canny hysteresis
reads a convergence flag back once a block of dilations (ops/canny.py).
The step records its spans in utils/profiling.py's call table:
``pipeline.step`` around ``pipeline.upload`` (the packing and the copy
started; the bytes in ``pipeline.h2d_bytes``) and ``pipeline.enqueue``
(the device work enqueued); with the enhancer, ``pipeline.enhance`` inside
the enqueue (the color warp and the enhancement; B2-B4's launches in
``pipeline.enhance_launches``). The resample kernel's launches in the
enqueue (a planar frame's squares or color tiles) count in
``pipeline.resample_launches`` (``resample_count``).

On the card, a conv pipeline without the enhancer replays ``step``'s
device chain as one CUDA graph from a frame kind's third call on
(utils/graphs.py; ``VisionPipeline.step`` says when and why).
"""

from __future__ import annotations

import math
from contextlib import contextmanager, nullcontext
from typing import NamedTuple, Optional

import numpy as np
import torch

from chessboard_vision_tpu_torch.device import resolve_device
from chessboard_vision_tpu_torch.geometry import BoardGeometry
from chessboard_vision_tpu_torch.kernels import bilateral as kb
from chessboard_vision_tpu_torch.kernels import clahe as kc
from chessboard_vision_tpu_torch.kernels import resample as kr
from chessboard_vision_tpu_torch.models import piece_detector as pd_model
from chessboard_vision_tpu_torch.models.enhancer import enhance_planar
from chessboard_vision_tpu_torch.ops import change as change_ops
from chessboard_vision_tpu_torch.ops import hough as hough_ops
from chessboard_vision_tpu_torch.ops import hough_conv as hough_conv_ops
from chessboard_vision_tpu_torch.ops import matmul_resample as mr
from chessboard_vision_tpu_torch.ops import piece as piece_ops
from chessboard_vision_tpu_torch.ops import warp as warp_ops
from chessboard_vision_tpu_torch.ops.color import bgr2gray, planar_bgr2gray
from chessboard_vision_tpu_torch.ops.filters import gaussian_blur_valid
from chessboard_vision_tpu_torch.ops.layout import positions_to_mask
from chessboard_vision_tpu_torch.utils.graphs import StepGraphs
from chessboard_vision_tpu_torch.utils.profiling import count, span


class PipelineState(NamedTuple):
    piece: pd_model.PieceState
    change: change_ops.ChangeModelState


class StepConsts(NamedTuple):
    """The per-square device constants the step core reads. A
    VisionPipeline holds its 64 squares' (``VisionPipeline.consts``); the
    stream-folded N-stream step passes them tiled to N*64 squares
    (parallel/multistream.py). The Hough backend's constants are set and
    the other backend's are None: ``params`` for exact, ``conv_plan`` and
    ``conv_dims`` for conv."""

    dg: warp_ops.DeviceGeometry
    masks: piece_ops.PieceMasks
    params: Optional[hough_ops.HoughParams]
    conv_plan: Optional[hough_conv_ops.ConvHoughPlan]
    conv_dims: Optional[hough_conv_ops.ConvHoughDims]


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


_HOST_DTYPES = {torch.bool: np.bool_, torch.int32: np.int32, torch.float32: np.float32}


def pack_leaves(leaves) -> torch.Tensor:
    """Device tensors of bool, i32 or f32 (any shapes) -> one int32 tensor on
    their device, every leaf packed into it bit for bit, for ONE D2H copy."""
    return torch.cat([
        (x.view(torch.int32) if x.dtype == torch.float32 else x.to(torch.int32)).reshape(-1)
        for x in leaves
    ])


def unpack_leaves(packed: np.ndarray, leaves) -> list:
    """``pack_leaves(leaves)`` read back to the host -> a numpy array of each
    leaf's dtype and shape."""
    host, at = [], 0
    for x in leaves:
        v = packed[at : at + x.numel()].reshape(tuple(x.shape))
        at += x.numel()
        dt = _HOST_DTYPES[x.dtype]
        host.append(v.view(dt) if dt == np.float32 else v.astype(dt))
    return host


def leaves_to_numpy(leaves) -> list:
    """Device tensors of bool, i32 or f32 (any shapes) -> host numpy arrays,
    in ONE D2H copy (pack_leaves)."""
    return unpack_leaves(pack_leaves(leaves).cpu().numpy(), leaves)


def outputs_to_numpy(out: StepOutputs) -> StepOutputs:
    """Device StepOutputs (any leading shape) -> host numpy, in one D2H copy."""
    return StepOutputs(*leaves_to_numpy(out))


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
    for the CPU; without a card, "cuda" raises. ``hough_backend`` is
    "conv", "exact" or "auto": exact on a CPU device, conv on the card.
    ``with_change_detector=False`` leaves the EMA change model out of the
    step: its state passes through and the change outputs are zeros.
    ``bilateral_backend`` is the enhancer's bilateral backend ("auto",
    "kernel", "plain": models/enhancer.bilateral).
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
        with_change_detector: bool = True,
        bilateral_backend: str = "auto",
        device="cuda",
    ):
        self.device = resolve_device(device, "VisionPipeline")
        if hough_backend == "auto":
            # The JAX package picks conv on its accelerator (scatter voting
            # serializes there) and exact elsewhere; the card plays the
            # accelerator's role. Read from the pipeline's device alone.
            hough_backend = "conv" if self.device.type == "cuda" else "exact"
        if hough_backend not in ("conv", "exact"):
            raise ValueError(f"hough_backend={hough_backend!r}: use 'conv', 'exact' or 'auto'")
        self.hough_backend = hough_backend
        self.geometry = geometry
        s = geometry.squares
        heights, widths = s.heights, s.widths
        self.H, self.W = int(heights.max()), int(widths.max())

        min_ratio, max_ratio = 0.20, 0.55
        if piece_settings:
            if "min_radius" in piece_settings:
                min_ratio = piece_settings["min_radius"] / 100.0
            if "max_radius" in piece_settings:
                max_ratio = piece_settings["max_radius"] / 100.0
        params = conv_plan = conv_dims = None
        self.bounds = None  # the exact backend's static loop and shape bounds
        if hough_backend == "conv":
            # Bounded hysteresis (2 rounds) on the conv path, as in the JAX package.
            conv_plan, conv_dims = hough_conv_ops.ConvHoughPlan.build(
                heights, widths, min_ratio=min_ratio, max_ratio=max_ratio,
                plane_h=self.H, plane_w=self.W, hysteresis_rounds=2, device=self.device,
            )
        else:
            params, self.bounds = hough_ops.HoughParams.from_geometry(
                heights, widths, min_ratio=min_ratio, max_ratio=max_ratio, device=self.device,
            )
        self.consts = StepConsts(
            dg=warp_ops.DeviceGeometry.from_host(geometry, device=self.device),
            masks=piece_ops.PieceMasks.build(heights, widths, self.H, self.W, device=self.device),
            params=params,
            conv_plan=conv_plan,
            conv_dims=conv_dims,
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
        self.bilateral_backend = bilateral_backend
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

        self.with_change = with_change_detector
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

        self._graphs = StepGraphs(self.device) if graphs_engage(
            self.device, hough_backend, with_enhancer) else None

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

    def preprocess(self, frames: torch.Tensor):
        """(..., 3, Hf, Wf) planar or (..., Hf, Wf, 3) HWC u8, any leading
        stream axes -> blurred gray squares (n, H, W) u8 for the piece
        cascade, 64 a frame in stream-major order, and the change model's
        own-blur squares (None when the change model shares the 5x5 blur).
        Planar frames take the matmul resample, HWC frames the gather warp."""
        if self.with_enhancer:
            with enhance_span():
                if is_hwc(frames):
                    boards = warp_ops.frame_to_board(frames, self.consts.dg).movedim(-1, -3)
                else:
                    boards = mr.warp_board_color(frames, self._tile_plan, self._tile_dims,
                                                 self._tile_index)
                gray_padded = self._enhanced_squares(boards)
        elif is_hwc(frames):
            board = warp_ops.frame_to_board(frames, self.consts.dg)  # (..., B, B, 3)
            # Gray first, then the square gather: the same pixels as
            # bgr2gray(extract_squares(board)), from one channel.
            gray_padded = warp_ops.extract_gray_squares(bgr2gray(board), self.consts.dg)
        else:
            gray_padded = mr.resample_gray_u8(planar_bgr2gray(frames), self._mm_plan, self._mm_dims)
        return self.blur(gray_padded.reshape((-1,) + tuple(gray_padded.shape[-2:])))

    def _enhanced_squares(self, boards: torch.Tensor) -> torch.Tensor:
        """(..., 3, B, B) color boards -> (n, H+2p, W+2p) enhanced padded
        gray squares, 64 a board in board order: every board enhanced on
        its own in one batched enhancement (one launch each of B2-B4 for
        all boards), then grayscaled and its squares gathered."""
        boards = enhance_planar(boards.reshape((-1,) + tuple(boards.shape[-3:])),
                                self.enhancer_profile, bilateral_backend=self.bilateral_backend)
        gray = planar_bgr2gray(boards)  # (N, B, B)
        squares = gray.reshape(gray.shape[0], -1)[:, self._ext_index]  # (N, 64, H+2p, W+2p)
        return squares.reshape((-1,) + tuple(squares.shape[-2:]))

    def blur(self, gray_padded: torch.Tensor):
        """Padded gray squares (n, H+2p, W+2p) u8 -> (the piece cascade's
        5x5-blurred (n, H, W), the change model's own blur or None)."""
        gray = gaussian_blur_valid(gray_padded, 5, pad=self._pad)
        if self.change_blur == 5:
            return gray, None
        return gray, gaussian_blur_valid(gray_padded, self.change_blur, pad=self._pad)

    def _step_impl(self, state, frame, s2c_mask, s2c_given, refresh_refs,
                   use_smoothing=True, use_delta=True):
        gray, gray_cd = self.preprocess(frame)
        return self._step_core(
            state, gray, s2c_mask, s2c_given, refresh_refs, self.consts, gray_change=gray_cd,
            use_smoothing=use_smoothing, use_delta=use_delta,
        )

    def _step_core(self, state, gray, s2c_mask, s2c_given, refresh_refs, consts: StepConsts,
                   gray_change=None, use_smoothing=True, use_delta=True):
        """Everything after preprocessing: detection cascade, change model,
        temporal state, on (n, H, W) squares with ``consts`` for the same n
        squares. ``s2c_given`` and ``refresh_refs`` are () for the whole
        board or (n,) per square (the stream-folded N-stream step, where
        each stream's 64 squares carry that stream's flags).
        ``gray_change`` is the change model's own-blur gray (None: gray).
        ``use_smoothing``/``use_delta`` go to the detector (detect_all)."""
        gray_flat = change_ops.flatten_pixels(gray)
        # Post-move forced re-reference, applied with this frame's gray.
        refresh_px = refresh_refs if refresh_refs.dim() == 0 else refresh_refs[:, None]
        p = state.piece
        piece_in = p._replace(
            ref_gray=torch.where(refresh_px, gray_flat, p.ref_gray),
            has_ref=p.has_ref | refresh_refs,
            has_cache=p.has_cache & ~refresh_refs,
        )
        piece_state, det = pd_model.detect_all(
            piece_in, gray, consts.masks, s2c_mask, s2c_given,
            consts.conv_plan, consts.conv_dims,
            gray_flat=gray_flat, hough_backend=self.hough_backend,
            params=consts.params, bounds=self.bounds,
            use_smoothing=use_smoothing, use_delta=use_delta, **self._det_kwargs,
        )
        if self.with_change:
            gcd = gray_flat if gray_change is None else change_ops.flatten_pixels(gray_change)
            cdet = change_ops.detect(
                state.change, gcd, self.z_threshold, consts.dg.sq_mask_flat, consts.dg.sq_counts,
            )
            change_state = change_ops.update_references(
                state.change, gcd, self.alpha,
                torch.ones((gcd.shape[0],), dtype=torch.bool, device=gcd.device),
            )
            intensity, pct, zpeak = cdet.intensity, cdet.pct_changed, cdet.z_peak
        else:  # the change state passes through; its outputs are zeros
            change_state = state.change
            n, dev = gray.shape[0], gray.device
            intensity = torch.zeros((n,), dtype=torch.int32, device=dev)
            pct = torch.zeros((n,), dtype=torch.float32, device=dev)
            zpeak = torch.zeros((n,), dtype=torch.float32, device=dev)

        outputs = StepOutputs(
            occupancy=det.has_piece,
            raw_occupancy=det.raw_has_piece,
            visual_changes=det.visual_changes,
            method=det.method,
            confidence=det.confidence,
            radius=det.radius,
            change_intensity=intensity,
            change_pct=pct,
            change_z_peak=zpeak,
            center_mean=det.center_mean,
            corner_mean=det.border_mean,
            profile_extent=det.extent,
        )
        return PipelineState(piece=piece_state, change=change_state), outputs

    def _upload(self, frames, s2c_mask: np.ndarray, flags, out=None) -> tuple:
        """Frame(s) with the (64,) square mask and the flags -> device views
        (frames, mask, flags). Host frames go up with the flags in one
        ``upload``, and an HWC one is then taken planar, as the JAX ``step``
        takes a host frame; a tensor keeps its layout. With ``out`` (a u8
        device buffer of the frames' bytes and the flags) everything lands
        in it: a tensor's bytes are copied to its head."""
        packed_flags = np.concatenate([s2c_mask, np.asarray(flags, bool)])
        if isinstance(frames, torch.Tensor):
            n = frames.numel()
            frames_d = to_device(frames, self.device,
                                 None if out is None else out[:n].view(frames.shape))
            _, packed = upload(np.zeros(0, np.uint8), packed_flags, self.device,
                               None if out is None else out[n:])
        else:
            frames_d, packed = upload(frames, packed_flags, self.device, out)
            if is_hwc(frames_d):
                frames_d = frames_d.movedim(-1, -3)
        return frames_d, packed[:64], packed[64:]

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
        return self._capture_core(state, *self.preprocess(frame_dev))

    def _capture_core(self, state: PipelineState, gray, gray_change=None) -> PipelineState:
        piece = pd_model.update_references(state.piece, gray)
        gcd = gray if gray_change is None else gray_change
        change = change_ops.calibrate(gcd, self.initial_variance)
        return PipelineState(piece=piece, change=change)

    def step(
        self,
        state: PipelineState,
        frame,
        squares_to_check=None,
        refresh_refs: bool = False,
        use_smoothing: bool = True,
        use_delta: bool = True,
    ):
        """Process one frame: (H, W, 3) HWC or (3, H, W) planar BGR u8, a
        host array (HWC taken planar) or a tensor (in its layout).
        squares_to_check: optional set of (file, rank) to force a fresh
        detection on; refresh_refs forces a visual re-reference from this
        frame first. ``use_smoothing=False`` reports this frame's raw
        detection instead of the 5-frame vote; ``use_delta=False`` with
        squares_to_check detects only those squares afresh (detect_all).
        ``state`` is not written to: the step returns a new one. Returns
        (state, StepOutputs on the device); no later call writes a tensor
        it returned.

        On the card, a pipeline with the conv backend and no enhancer
        replays the step's device chain as one CUDA graph
        (utils/graphs.py): a graph for each kind of call (the frame's
        shape, dtype, host or tensor, and the two ``use_`` flags), captured
        on the kind's third call, after two eager calls have filled the
        lazy caches, and replayed from then on. The square mask and both
        flags reach the card in the uploaded buffer, so smart-scan,
        full-scan and refresh frames replay one graph. The state's leaves
        are copied in (one batched copy) and the new state and outputs
        copied out (one copy); the outputs are bit-equal to the eager
        step's. It stays eager on the CPU, on the exact backend
        (its Canny reads a convergence flag back mid-step), with the
        enhancer (the bilateral's first call synchronizes, the color
        conversion uploads a scalar) and for tensor frames that are not u8.
        ``step_many`` stays eager."""
        with span("pipeline.step"):
            given = squares_to_check is not None
            mask = positions_to_mask(squares_to_check) if given else np.zeros(64, bool)
            graphs = self._graphs
            with nullcontext() if graphs is None else graphs.lock:
                graph = self._graph_for(frame, use_smoothing, use_delta)
                frame_dev, s2c_mask, flags = self._upload(
                    frame, mask, (given, refresh_refs), None if graph is None else graph.inputs)

                def impl(st):
                    return self._step_impl(st, frame_dev, s2c_mask, flags[0], flags[1],
                                           use_smoothing, use_delta)

                with span("pipeline.enqueue"), resample_count():
                    return impl(state) if graph is None else graph.run(state, impl)

    def _graph_for(self, frame, use_smoothing: bool, use_delta: bool):
        """The CUDA graph of this kind of step call, or None: run eagerly."""
        if self._graphs is None:
            return None
        on_device = isinstance(frame, torch.Tensor)
        if on_device and frame.dtype != torch.uint8:
            return None
        shape = tuple(frame.shape) if on_device else np.shape(frame)
        key = (on_device, shape, str(getattr(frame, "dtype", None)), use_smoothing, use_delta)
        return self._graphs.get(key, math.prod(shape) + 64 + 2)  # frame, mask, two flags

    def step_many(
        self,
        state: PipelineState,
        frames,
        squares_to_check=None,
        refresh_first: bool = False,
        use_smoothing: bool = True,
        use_delta: bool = True,
    ):
        """Process a chunk of K frames: (K, H, W, 3) or (K, 3, H, W) u8, routed
        as in ``step``.

        One H2D copy for the chunk, a device-side loop of K steps with the
        same per-frame semantics as K sequential ``step`` calls, outputs
        stacked to (K, 64) on the device (one D2H via outputs_to_numpy).
        squares_to_check, use_smoothing and use_delta apply to every frame;
        refresh_first re-references from frame 0 only."""
        given = squares_to_check is not None
        mask = positions_to_mask(squares_to_check) if given else np.zeros(64, bool)
        frames_dev, s2c_mask, flags = self._upload(
            frames, mask, (given, refresh_first, False)
        )
        given_d, refresh_d, no_refresh = flags[0], flags[1], flags[2]
        outs = []
        for i in range(frames_dev.shape[0]):
            state, out = self._step_impl(
                state, frames_dev[i], s2c_mask, given_d, refresh_d if i == 0 else no_refresh,
                use_smoothing, use_delta,
            )
            outs.append(out)
        return state, StepOutputs(*(torch.stack(f) for f in zip(*outs)))

    def warp_board(self, frame) -> np.ndarray:
        """The top-down board of an (H, W, 3) HWC BGR u8 frame, (B, B, 3) u8
        on the host, by the gather warp (ops/warp.py) on the pipeline's
        device (UI, calibration and api.extract_grid). Its lerps round op by
        op, as the JAX ``warp_board``, which runs outside jit."""
        frame_dev = torch.as_tensor(np.asarray(frame, np.uint8), device=self.device)
        return warp_ops.frame_to_board(frame_dev, self.consts.dg, contract=False).cpu().numpy()


def _enhance_launches() -> int:
    """B2-B4's launches so far: the bilateral, CLAHE's histograms with their
    LUTs, CLAHE's apply (the kernel wrappers' own counters)."""
    return kb.bilateral_planar.launches + kc.clahe_hist_luts.launches + kc.clahe_apply.launches


@contextmanager
def enhance_span():
    """The span ``pipeline.enhance`` around one call's color warp and
    enhancement of all its boards, and the counter
    ``pipeline.enhance_launches``: B2-B4's launches inside it (3 for a batch
    of boards on the card, one each; 0 on the CPU, where their plain
    versions run)."""
    before = _enhance_launches()
    with span("pipeline.enhance"):
        yield
        count("pipeline.enhance_launches", _enhance_launches() - before)


@contextmanager
def resample_count():
    """The counter ``pipeline.resample_launches``: the resample kernel's
    launches inside the block (a graph replay's too: utils/graphs.py adds
    them to the wrapper's count). Recorded only where the kernel launched,
    so on the CPU, where the plain ops run, the call has none (reads 0)."""
    before = kr.resample_u8.launches
    yield
    if kr.resample_u8.launches > before:
        count("pipeline.resample_launches", kr.resample_u8.launches - before)


def graphs_engage(device: torch.device, hough_backend: str, with_enhancer: bool) -> bool:
    """Whether ``VisionPipeline.step`` replays CUDA graphs: on the card,
    with the conv backend and without the enhancer."""
    return device.type == "cuda" and hough_backend == "conv" and not with_enhancer


def is_hwc(frames) -> bool:
    """Whether frames (any leading axes) are in the HWC camera layout
    (..., H, W, 3) rather than planar (..., 3, H, W)."""
    return frames.shape[-1] == 3 and frames.shape[-3] != 3


def upload(frames, flags: np.ndarray, device: torch.device, out=None) -> tuple:
    """One H2D copy: host frames (HWC camera layout or planar u8, any
    leading axes), their bytes as they are, in one host buffer together
    with the bool array ``flags``; the buffer is page-locked on CUDA, so the
    copy is asynchronous. It lands in a new device buffer, or in ``out`` (a
    u8 device tensor of the buffer's size). Returns views of it (frames in
    their layout, flags in their shape). The span ``pipeline.upload``; the
    buffer's bytes count in ``pipeline.h2d_bytes`` when it goes to a device
    other than the CPU."""
    with span("pipeline.upload"):
        frames = np.asarray(frames, np.uint8)
        flags = np.asarray(flags, bool)
        n = frames.size
        host = torch.empty(n + flags.size, dtype=torch.uint8, pin_memory=device.type == "cuda")
        buf = host.numpy()
        buf[:n].reshape(frames.shape)[...] = frames
        buf[n:] = flags.reshape(-1)
        if device.type != "cpu":
            count("pipeline.h2d_bytes", host.numel())
        t = host.to(device, non_blocking=True) if out is None else out.copy_(host, non_blocking=True)
        return t[:n].view(frames.shape), t[n:].view(torch.bool).view(flags.shape)


def to_device(frames: torch.Tensor, device, out=None) -> torch.Tensor:
    """``frames.to(device)``, or copied into ``out`` (a tensor of its shape
    and dtype on ``device``); a host tensor's bytes going to the card count
    in ``pipeline.h2d_bytes``."""
    if frames.device.type == "cpu" and torch.device(device).type != "cpu":
        count("pipeline.h2d_bytes", frames.numel() * frames.element_size())
    return frames.to(device) if out is None else out.copy_(frames)


def occupancy_to_set(occ) -> set:
    """(64,) bool (chess-index order) -> {(file, rank)} set."""
    if isinstance(occ, torch.Tensor):
        occ = occ.cpu().numpy()
    occ = np.asarray(occ)
    return {(sq % 8, sq // 8) for sq in range(64) if occ[sq]}
