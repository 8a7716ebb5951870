"""Batched N-stream pipeline: N camera streams in one step per frame tick.

Counterpart of chessboard_vision_tpu.parallel.multistream (without its
mesh: multi-GPU is ROADMAP A14). A tick runs the stream-FOLDED core: the
N streams' squares are extracted and blurred, then the geometry-independent
perception core (``VisionPipeline._step_core``) runs once on (N*64, H, W)
with every per-square constant tiled N-fold, stream-major (stream s,
square q -> s*64 + q). The core is the single-stream step with more
squares, so each of its ops launches once per tick whatever N is, and the
Hough score matmul (kernel B1) runs once with N*64 columns. Every folded
op is elementwise or a per-square reduction, so each stream's outputs are
those of a single-stream pipeline. The device noise FSM (ops/fsm.py) then
steps all N streams on (N, 64).

Frames: with one shared geometry, HWC camera frames (host arrays too, as
in the JAX package's tick, unlike its single-stream ``step``) take the
single-stream pipeline's gather warp (ops/warp.py) and planar frames its
matmul resample. Per-stream calibration: pass a LIST of N
BoardGeometry objects instead of one. Each stream's squares are then
resampled with its own plan (with the enhancer: its board warped with its
own tile plan) from planar frames (HWC frames are permuted to planar on the
device, the JAX package's host conversion); the rest is shared. All rigs
must share the grid structure (square heights and widths) and the capture
resolution; corners may differ.

The enhanced path enhances each stream's board on its own, as the
single-stream pipeline does: the bilateral and CLAHE kernels launch once
per stream per tick.

Host <-> device traffic: ``step`` makes one H2D copy per tick and
``step_chunk`` one per chunk (frames, square masks and flags packed
together, models/pipeline.upload); ``outputs_to_numpy`` reads a tick's or
a chunk's outputs back in one D2H copy.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from chessboard_vision_tpu_torch.device import resolve_device
from chessboard_vision_tpu_torch.models import pipeline as tp
from chessboard_vision_tpu_torch.models import piece_detector as pd_model
from chessboard_vision_tpu_torch.models.pipeline import (
    PipelineState,
    StepConsts,
    StepOutputs,
    VisionPipeline,
)
from chessboard_vision_tpu_torch.ops import change as change_ops
from chessboard_vision_tpu_torch.ops import fsm as fsm_ops
from chessboard_vision_tpu_torch.ops import hough as hough_ops
from chessboard_vision_tpu_torch.ops import matmul_resample as mr
from chessboard_vision_tpu_torch.ops import piece as piece_ops
from chessboard_vision_tpu_torch.ops.color import planar_bgr2gray

# Per tick and stream, the uploaded flags: 64 square-mask bits, then
# "squares_to_check given" and "refresh references".
_GIVEN, _REFRESH, _FLAGS = 64, 65, 66


class MultiStreamState(NamedTuple):
    pipe: PipelineState  # leaves with a leading (N,) stream axis
    noise: fsm_ops.NoiseFsmState  # leaves with a leading (N,) stream axis


class MultiStreamOutputs(NamedTuple):
    step: StepOutputs  # leaves (N, 64)
    noise: fsm_ops.NoiseFsmOut  # leaves (N,) or (N, 64)


def _tile(x, n: int, last: bool = False):
    """A per-square constant of 64 squares -> of n*64, stream-major (stream
    s, square q -> s*64 + q): a tensor along its first axis, or along its
    last where the square axis is last; a tuple repeated."""
    if isinstance(x, tuple):
        return x * n
    reps = [1] * x.dim()
    reps[-1 if last else 0] = n
    return x.repeat(*reps)


def _map_pipe(fn, state: PipelineState) -> PipelineState:
    return PipelineState(
        piece=pd_model.PieceState(*map(fn, state.piece)),
        change=change_ops.ChangeModelState(*map(fn, state.change)),
    )


def _stack(outs: List[MultiStreamOutputs]) -> MultiStreamOutputs:
    """T ticks' outputs -> one MultiStreamOutputs with leaves (T, N, ...)."""
    return MultiStreamOutputs(
        StepOutputs(*(torch.stack(f) for f in zip(*(o.step for o in outs)))),
        fsm_ops.NoiseFsmOut(*(torch.stack(f) for f in zip(*(o.noise for o in outs)))),
    )


class MultiStreamPipeline:
    """N-stream batched pipeline on one device (the card unless the caller
    asks for the CPU)."""

    def __init__(
        self,
        geometry,
        n_streams: int,
        piece_settings: Optional[dict] = None,
        change_settings: Optional[dict] = None,
        detector_overrides: Optional[dict] = None,
        with_enhancer: bool = False,
        enhancer_profile: Optional[dict] = None,
        hough_backend: str = "auto",
        device="cuda",
    ):
        self.n_streams = n = int(n_streams)
        if isinstance(geometry, (list, tuple)):
            geos = list(geometry)
            if len(geos) != n:
                raise ValueError(f"got {len(geos)} geometries for {n} streams")
            base = geos[0]
            for i, g in enumerate(geos[1:], 1):
                if not (
                    np.array_equal(g.squares.heights, base.squares.heights)
                    and np.array_equal(g.squares.widths, base.squares.widths)
                    and (g.src_h, g.src_w) == (base.src_h, base.src_w)
                ):
                    raise ValueError(
                        f"stream {i}: per-stream geometries must share the grid "
                        "structure (square heights/widths) and capture resolution; "
                        "only corners/homography may differ"
                    )
        else:
            base, geos = geometry, None
        self.pipe = p = VisionPipeline(
            base,
            piece_settings=piece_settings,
            change_settings=change_settings,
            detector_overrides=detector_overrides,
            with_enhancer=with_enhancer,
            enhancer_profile=enhancer_profile,
            hough_backend=hough_backend,
            device=device,
        )
        self.device = p.device
        # Per-stream geometry: each stream's resample plan (the frame ->
        # board TILE plan with the enhancer, else the frame -> squares plan).
        self._stream_plans = None
        if geos is not None:
            self._stream_plans = []
            for g in geos:
                qx, qy = (g.board_tile_query_coords()[:2] if with_enhancer
                          else g.square_query_coords())
                self._stream_plans.append(
                    mr.build_plan(qx, qy, g.src_h, g.src_w, device=self.device)
                )

        plan, dims, dg = p.consts.conv_plan, p.consts.conv_dims, p.consts.dg

        def t(x):
            return _tile(x, n)

        self.consts = StepConsts(
            # The per-square geometry fields (the warp maps and square
            # gathers serve the shared-geometry preprocess, not the core).
            dg=dg._replace(sq_mask=t(dg.sq_mask), sq_mask_flat=t(dg.sq_mask_flat),
                           sq_counts=t(dg.sq_counts), sq_heights=t(dg.sq_heights),
                           sq_widths=t(dg.sq_widths)),
            masks=piece_ops.PieceMasks(*map(t, p.consts.masks)),
            params=None if p.consts.params is None else hough_ops.HoughParams(
                *map(t, p.consts.params)),
            # The score matmul's outputs and their validity table keep the
            # square axis last (column n of the (Mq, N*64) scores).
            conv_plan=None if plan is None else plan._replace(
                r_valid=t(plan.r_valid), r_min=t(plan.r_min), r_max=t(plan.r_max),
                win_offset_y=t(plan.win_offset_y), win_offset_x=t(plan.win_offset_x),
                win_mask=_tile(plan.win_mask, n, last=True),
                kvalid=_tile(plan.kvalid, n, last=True),
            ),
            conv_dims=None if dims is None else dims._replace(woy=t(dims.woy), wox=t(dims.wox)),
        )

    # -- device functions ------------------------------------------------

    def _squares(self, frames: torch.Tensor):
        """(N, 3, Hf, Wf) planar or (N, Hf, Wf, 3) HWC u8 -> folded blurred
        gray squares (N*64, H, W) u8 and the change model's own blur (or
        None)."""
        p = self.pipe
        if self._stream_plans is None:  # one batched warp or resample for the shared plan
            return p.preprocess(frames)
        if tp.is_hwc(frames):  # the per-stream plans resample planar frames
            frames = frames.movedim(-1, -3)
        if p.with_enhancer:
            padded = torch.cat([
                p._enhanced_board_squares(mr.warp_board_color(frames[i], plan, dims, p._tile_index))
                for i, (plan, dims) in enumerate(self._stream_plans)
            ])
        else:
            gray = planar_bgr2gray(frames)  # (N, Hf, Wf)
            padded = torch.cat([mr.resample_gray_u8(gray[i], plan, dims)
                                for i, (plan, dims) in enumerate(self._stream_plans)])
        return p.blur(padded)

    def _fold(self, x: torch.Tensor) -> torch.Tensor:  # (N, 64, ...) -> (N*64, ...)
        return x.reshape((self.n_streams * 64,) + tuple(x.shape[2:]))

    def _unfold(self, x: torch.Tensor) -> torch.Tensor:  # (N*64, ...) -> (N, 64, ...)
        return x.reshape((self.n_streams, 64) + tuple(x.shape[1:]))

    def _tick(self, state: MultiStreamState, frames: torch.Tensor, flags: torch.Tensor):
        """One tick on device tensors: frames (N, 3, Hf, Wf) or (N, Hf, Wf, 3) u8, flags
        (N, 66) bool (square masks, given, refresh)."""
        gray, gray_cd = self._squares(frames)
        pipe_state, out = self.pipe._step_core(
            _map_pipe(self._fold, state.pipe),
            gray,
            flags[:, :64].reshape(-1),
            flags[:, _GIVEN].repeat_interleave(64),
            flags[:, _REFRESH].repeat_interleave(64),
            self.consts,
            gray_change=gray_cd,
        )
        out = StepOutputs(*map(self._unfold, out))
        noise, noise_out = fsm_ops.noise_step(state.noise, out.visual_changes)
        return (MultiStreamState(_map_pipe(self._unfold, pipe_state), noise),
                MultiStreamOutputs(out, noise_out))

    # -- host API --------------------------------------------------------

    def init_state(self) -> MultiStreamState:
        n = self.n_streams
        return MultiStreamState(
            pipe=_map_pipe(lambda x: x.expand((n,) + tuple(x.shape)).clone(),
                           self.pipe.init_state()),
            noise=fsm_ops.init_state(n, device=self.device),
        )

    def capture_reference(self, state: MultiStreamState, frames) -> MultiStreamState:
        """Set every stream's visual references and change model from
        frames (N, H, W, 3) HWC or (N, 3, H, W) planar u8."""
        frames_d, _ = tp.upload(frames, np.zeros(0, bool), self.device)
        pipe = self.pipe._capture_core(_map_pipe(self._fold, state.pipe),
                                       *self._squares(frames_d))
        return MultiStreamState(pipe=_map_pipe(self._unfold, pipe), noise=state.noise)

    def _flags(self, lead, s2c_masks=None, refresh=None) -> np.ndarray:
        flags = np.zeros(lead + (self.n_streams, _FLAGS), bool)
        if s2c_masks is not None:
            flags[..., :64] = np.asarray(s2c_masks, bool).reshape(self.n_streams, 64)
            flags[..., _GIVEN] = True
        if refresh is not None:
            flags[..., _REFRESH] = np.asarray(refresh, bool).reshape(self.n_streams)
        return flags

    def step(self, state: MultiStreamState, frames, s2c_masks=None, refresh=None):
        """One tick for all N streams. frames: (N, H, W, 3) HWC or
        (N, 3, H, W) planar u8; s2c_masks: optional (N, 64) bool squares
        to force a fresh detection on; refresh: optional (N,) bool forced
        re-reference per stream. Returns (state, MultiStreamOutputs on the
        device)."""
        frames_d, flags = tp.upload(frames, self._flags((), s2c_masks, refresh), self.device)
        return self._tick(state, frames_d, flags)

    def step_chunk(self, state: MultiStreamState, frames):
        """T ticks for all N streams from one upload: frames (T, N, H, W, 3)
        or (T, N, 3, H, W) u8. Outputs have leading (T, N) axes; tick
        semantics equal T sequential ``step`` calls (no squares_to_check,
        no refresh)."""
        t_len = np.shape(frames)[0]
        frames_d, flags = tp.upload(frames, self._flags((t_len,)), self.device)
        outs = []
        for i in range(t_len):
            state, out = self._tick(state, frames_d[i], flags[i])
            outs.append(out)
        return state, _stack(outs)


def outputs_to_numpy(out: MultiStreamOutputs) -> MultiStreamOutputs:
    """Device MultiStreamOutputs (any leading axes) -> host numpy, in one
    D2H copy."""
    host = tp.leaves_to_numpy([*out.step, *out.noise])
    k = len(out.step)
    return MultiStreamOutputs(StepOutputs(*host[:k]), fsm_ops.NoiseFsmOut(*host[k:]))


def multistream_state_from_numpy(tree, device="cuda") -> MultiStreamState:
    """A MultiStreamState-shaped tree of arrays (e.g. the JAX package's
    state, leaves through ``np.asarray``) -> the port's state on ``device``
    (the card unless the caller asks for the CPU). Leaves are matched by
    field name."""
    device = resolve_device(device, "multistream_state_from_numpy")
    noise = fsm_ops.NoiseFsmState(**{
        name: torch.as_tensor(np.array(getattr(tree.noise, name)), device=device)
        for name in fsm_ops.NoiseFsmState._fields
    })
    return MultiStreamState(pipe=tp.state_from_numpy(tree.pipe, device=device), noise=noise)


def multistream_state_to_numpy(state: MultiStreamState) -> MultiStreamState:
    """The port's state -> the same tree with host numpy leaves."""
    return MultiStreamState(
        pipe=tp.state_to_numpy(state.pipe),
        noise=fsm_ops.NoiseFsmState(*(x.cpu().numpy() for x in state.noise)),
    )
