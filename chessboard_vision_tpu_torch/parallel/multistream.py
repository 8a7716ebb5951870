"""Batched N-stream pipeline, on one device or sharded over a stream mesh.

Counterpart of chessboard_vision_tpu.parallel.multistream. A tick runs the
stream-FOLDED core: the streams' squares are extracted and blurred, then
the geometry-independent perception core (``VisionPipeline._step_core``)
runs once on (n*64, H, W) with every per-square constant tiled n-fold,
stream-major (stream s, square q -> s*64 + q). The core is the
single-stream step with more squares, so each of its ops launches once per
tick whatever n is, and the Hough score matmul (kernel B1) runs once with
n*64 columns. Every folded op is elementwise or a per-square reduction, so
each stream's outputs are those of a single-stream pipeline. The device
noise FSM (ops/fsm.py) then steps the streams on (n, 64).

Mesh (``mesh=``, parallel/mesh.py): the same tick on each slot of a stream
mesh. Slot (d, k) holds streams [d*N/dp, (d+1)*N/dp) and runs the folded
core on squares [k*64/sp, (k+1)*64/sp) of them, with its per-square
constants and its state cut the same way (stream-major fold order). B1
launches once a slot a tick, at that slot's width. Frames are replicated
over "space" as the JAX package's ``P("data")`` frames are: each space slot
warps all 64 squares of its streams and keeps its block. The noise FSM
needs a stream's 64 ``visual_changes``: they are gathered from the row's
space slots to slot (d, 0), which owns the row's FSM state (XLA's
inserted all-gather in the JAX package). The base ``VisionPipeline`` and
its constants (the Hough basis is 45.9 MB at 1080p) are built once a
distinct device, not once a slot, and the tiled constants once a distinct
(device, streams, squares) shape. A tick makes one H2D upload a slot (its
own streams' frames and flags, onto its own device), then enqueues each
slot's tick in turn: the conv tick does not wait on the device, so slots on
different cards overlap; the exact backend reads a convergence flag back
once a block of dilations (ops/canny.py), which serializes the slots. A
tick's outputs come back as (N, 64) and (N,) leaves gathered onto the
mesh's first slot (a few KB); the state stays where each slot computes it
(``MeshState``). On a mesh that spans processes (parallel/distributed.py)
a process runs its own slots on its own streams: ``step`` takes the frames
of every data row in which it holds a slot (``frame_rows``; or all N, of
which it keeps those), and its outputs hold the rows it owns (``rows``),
whose global rows they name (``streams``). A data row's owner is the
process of its first slot, which holds the row's FSM state. A row whose
space slots belong to more than one process (the space axis does not
divide a process's slots) is run by each of them on its own square
blocks; each tick the owner's flags (square masks, re-reference) go to
the others first, and their blocks' outputs, ``visual_changes`` among
them, come back to the owner after the core (distributed.row_gather), so
the other processes report none of that row.

Frames: with one shared geometry, HWC camera frames (host arrays too, as
in the JAX package's tick, unlike its single-stream ``step``) take the
single-stream pipeline's gather warp (ops/warp.py) and planar frames its
matmul resample. Per-stream calibration: pass a LIST of N BoardGeometry
objects instead of one. Each stream's squares are then resampled with its
own plan (with the enhancer: its board warped with its own tile plan) from
planar frames (HWC frames are viewed planar on the device, the JAX
package's host conversion); the rest is shared. A slot's plans are stacked
once, at build, and its boards resample together
(matmul_resample.resample_boards_u8): on a card one launch of the resample
kernel a tick and slot, counted in ``pipeline.resample_launches``
(models/pipeline.resample_count). All rigs must share the grid structure
(square heights and widths) and the capture resolution; corners may differ.

The enhanced path enhances each stream's board on its own, as the
single-stream pipeline does, all of a slot's boards in one batch: the
boards' color warps, each with its own tile plan, are that one resample
(matmul_resample.warp_boards_color), and the bilateral and CLAHE kernels
launch once a tick (once a slot on a mesh),
inside the span ``pipeline.enhance`` with their launches counted in
``pipeline.enhance_launches`` (models/pipeline.enhance_span).

Host <-> device traffic: ``step`` makes one H2D copy per tick and slot and
``step_chunk`` one per chunk and slot (frames, square masks and flags
packed together, models/pipeline.upload); ``outputs_to_numpy`` reads a
tick's or a chunk's outputs back in one D2H copy. Frames given as a tensor
(on any device, in its layout, as the single-stream ``step`` takes one)
do not go through the host: each slot takes its streams' rows with
``.to`` its device (no copy where they already lie there), and only the
flags are uploaded.
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
from chessboard_vision_tpu_torch.parallel import distributed as pdist
from chessboard_vision_tpu_torch.parallel import mesh as mesh_lib
from chessboard_vision_tpu_torch.utils.checkpoint import tree_map
from chessboard_vision_tpu_torch.utils.profiling import span

# Per tick and stream, the uploaded flags: 64 square-mask bits, then
# "squares_to_check given" and "refresh references".
_GIVEN, _REFRESH, _FLAGS = 64, 65, 66
ALL_SQUARES = range(64)


class MultiStreamState(NamedTuple):
    pipe: PipelineState  # leaves with a leading (N,) stream axis
    noise: fsm_ops.NoiseFsmState  # leaves with a leading (N,) stream axis


class MeshState(NamedTuple):
    """A meshed pipeline's state, left where each slot computes it."""

    pipe: tuple  # one PipelineState a local slot, mesh order: leaves (N/dp, 64/sp, ...)
    noise: tuple  # one NoiseFsmState an owned data row, on its first slot: leaves (N/dp, ...)
    # Per local slot, in ``pipe``'s order: (data row, first square, end square).
    blocks: tuple = ()


class MultiStreamOutputs(NamedTuple):
    step: StepOutputs  # leaves (N, 64)
    noise: fsm_ops.NoiseFsmOut  # leaves (N,) or (N, 64)
    # The global stream rows the leaves hold: all N, or on a mesh that spans
    # processes this process's streams (the JAX array's addressable shards).
    streams: Optional[range] = None


class _Slot(NamedTuple):
    block: mesh_lib.SlotBlock
    pipe: VisionPipeline  # the device's pipeline, shared by its slots
    consts: StepConsts  # per-square constants of the slot's streams and squares
    # per-stream geometry: the slot's streams' plans (tile plans with the
    # enhancer) stacked (matmul_resample.stack_plans) and the first
    # stream's dims; None for the shared geometry
    board_plan: Optional[tuple] = None


class _Row(NamedTuple):
    """A data row in which this process holds a slot."""

    index: int  # the data row
    slots: list  # indices into the pipeline's ``slots`` of this process's slots of the row
    blocks: list  # every slot's block of the row, this process's or not
    owner: int  # the rank of the row's first slot, which holds its FSM state
    ranks: list  # the ranks holding its slots, owner first; one for a row in one process
    group: object  # the row's process group (None for a row in one process)

    @property
    def split(self) -> bool:
        return len(self.ranks) > 1


def _tile(x, n: int, squares: range = ALL_SQUARES, last: bool = False):
    """A per-square constant of 64 squares -> of the block ``squares`` of n
    streams, stream-major (stream s, block square j -> s*len(squares) + j):
    a tensor along its first axis, or along its last where the square axis
    is last; a tuple cut and repeated."""
    if isinstance(x, tuple):
        return x[squares.start:squares.stop] * n
    if squares != ALL_SQUARES:
        x = x[..., squares.start:squares.stop] if last else x[squares.start:squares.stop]
    reps = [1] * x.dim()
    reps[-1 if last else 0] = n
    return x.repeat(*reps)


def _slot_consts(p: VisionPipeline, n: int, squares: range) -> StepConsts:
    plan, dims, dg = p.consts.conv_plan, p.consts.conv_dims, p.consts.dg

    def t(x):
        return _tile(x, n, squares)

    return StepConsts(
        # The per-square geometry fields (the warp maps and square gathers
        # serve the shared-geometry preprocess, not the core).
        dg=dg._replace(sq_mask=t(dg.sq_mask), sq_mask_flat=t(dg.sq_mask_flat),
                       sq_counts=t(dg.sq_counts), sq_heights=t(dg.sq_heights),
                       sq_widths=t(dg.sq_widths)),
        masks=piece_ops.PieceMasks(*map(t, p.consts.masks)),
        params=None if p.consts.params is None else hough_ops.HoughParams(
            *map(t, p.consts.params)),
        # The score matmul's outputs and their validity table keep the
        # square axis last (column n of the (Mq, n*64) scores).
        conv_plan=None if plan is None else plan._replace(
            r_valid=t(plan.r_valid), r_min=t(plan.r_min), r_max=t(plan.r_max),
            win_offset_y=t(plan.win_offset_y), win_offset_x=t(plan.win_offset_x),
            win_mask=_tile(plan.win_mask, n, squares, last=True),
            kvalid=_tile(plan.kvalid, n, squares, last=True),
        ),
        conv_dims=None if dims is None else dims._replace(woy=t(dims.woy), wox=t(dims.wox)),
    )


def _map_pipe(fn, state: PipelineState) -> PipelineState:
    return PipelineState(
        piece=pd_model.PieceState(*map(fn, state.piece)),
        change=change_ops.ChangeModelState(*map(fn, state.change)),
    )


def _fold(x: torch.Tensor) -> torch.Tensor:  # (n, m, ...) -> (n*m, ...)
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _assemble(parts: list, per_row: int, device) -> tuple:
    """Trees of one structure, one a slot in mesh order, leaves (n, m, ...)
    or (n, ...) -> one tree on ``device``: a row's ``per_row`` parts joined
    along the square axis, the rows along the stream axis."""
    if len(parts) == 1:
        return tree_map(lambda x: x.to(device), parts[0])

    def join(*xs):
        xs = [x.to(device) for x in xs]
        if per_row > 1:
            xs = [torch.cat(xs[i:i + per_row], dim=1) for i in range(0, len(xs), per_row)]
        return torch.cat(xs)

    return tree_map(join, *parts)


def _stack(outs: List[MultiStreamOutputs]) -> MultiStreamOutputs:
    """T ticks' outputs -> one MultiStreamOutputs with leaves (T, N, ...)."""
    return MultiStreamOutputs(
        StepOutputs(*(torch.stack(f) for f in zip(*(o.step for o in outs)))),
        fsm_ops.NoiseFsmOut(*(torch.stack(f) for f in zip(*(o.noise for o in outs)))),
        outs[0].streams,
    )


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """A bool, i32 or f32 tensor as i32, bit for bit where it is f32."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x.to(torch.int32)


def _from_i32(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(torch.float32) if dtype == torch.float32 else x.to(dtype)


def _positions(blocks) -> tuple:
    """MeshState.blocks of slot blocks: (data row, first square, end square)."""
    return tuple((b.position[0], b.squares.start, b.squares.stop) for b in blocks)


class MultiStreamPipeline:
    """N-stream batched pipeline on one device (the card unless the caller
    asks for the CPU), or over the slots of a stream mesh (``mesh``, with
    a data and optionally a space axis; ``device`` may then only name the
    mesh's first slot)."""

    def __init__(
        self,
        geometry,
        n_streams: int,
        mesh: Optional[mesh_lib.StreamMesh] = None,
        piece_settings: Optional[dict] = None,
        change_settings: Optional[dict] = None,
        detector_overrides: Optional[dict] = None,
        with_enhancer: bool = False,
        enhancer_profile: Optional[dict] = None,
        hough_backend: str = "auto",
        with_change_detector: bool = True,
        bilateral_backend: str = "auto",
        device=None,
    ):
        self.n_streams = n = int(n_streams)
        self.mesh = mesh
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
        blocks, everyone = self._blocks(device)

        pipes, consts, plans = {}, {}, {}
        self.slots: List[_Slot] = []
        for b in blocks:
            if b.device not in pipes:
                pipes[b.device] = VisionPipeline(
                    base,
                    piece_settings=piece_settings,
                    change_settings=change_settings,
                    detector_overrides=detector_overrides,
                    with_enhancer=with_enhancer,
                    enhancer_profile=enhancer_profile,
                    hough_backend=hough_backend,
                    with_change_detector=with_change_detector,
                    bilateral_backend=bilateral_backend,
                    device=b.device,
                )
            p = pipes[b.device]
            key = (b.device, len(b.streams), b.squares.start, b.squares.stop)
            if key not in consts:
                consts[key] = _slot_consts(p, len(b.streams), b.squares)
            board_plan = None
            if geos is not None:
                # Each stream's resample plan (the frame -> board TILE plan
                # with the enhancer, else the frame -> squares plan), once a
                # device that holds the stream.
                for s in b.streams:
                    if (b.device, s) not in plans:
                        g = geos[s]
                        qx, qy = (g.board_tile_query_coords()[:2] if with_enhancer
                                  else g.square_query_coords())
                        plans[b.device, s] = mr.build_plan(qx, qy, g.src_h, g.src_w,
                                                           device=b.device)
                board_plan = (mr.stack_plans([plans[b.device, s][0] for s in b.streams]),
                              plans[b.device, b.streams[0]][1])
            self.slots.append(_Slot(b, p, consts[key], board_plan))
        first = self.slots[0]
        self.pipe, self.consts, self.device = first.pipe, first.consts, first.block.device
        self._stream_plans = first.board_plan
        self._rows = self._layout(everyone)
        # The rows whose frames ``step`` takes, and the rows it reports.
        self.frame_rows = mesh_lib.local_rows(blocks)
        owned = [s for r in self._owned() for s in r.blocks[0].streams]
        self.rows = (range(owned[0], owned[-1] + 1) if owned
                     else range(self.frame_rows.start, self.frame_rows.start))
        if list(self.rows) != owned:
            raise ValueError(f"the rows process {self._process} owns are not contiguous: "
                             f"{owned}")

    @property
    def _process(self) -> int:
        return 0 if self.mesh is None else self.mesh.process

    def _blocks(self, device):
        """(this process's slots, every slot): one slot holding every stream
        and square without a mesh, else the mesh's slots."""
        if self.mesh is None:
            dev = resolve_device("cuda" if device is None else device, "MultiStreamPipeline")
            blocks = [mesh_lib.SlotBlock((0, 0), dev, 0, range(self.n_streams), ALL_SQUARES)]
            return blocks, blocks
        sharding = mesh_lib.stream_square_sharding(self.mesh)
        everyone = sharding.blocks(self.n_streams)
        blocks = sharding.local_blocks(self.n_streams)
        if not blocks:
            raise ValueError(f"no slot of {self.mesh} belongs to process {self.mesh.process}")
        if device is not None and mesh_lib.slot_device(device) != blocks[0].device:
            raise ValueError(f"device {str(device)!r} disagrees with the mesh, whose first "
                             f"slot of this process is {blocks[0].device}")
        return blocks, everyone

    def _layout(self, everyone) -> List[_Row]:
        """The data rows in which this process holds a slot; the groups of
        the rows split over processes are made here, on every process."""
        groups = {} if self.mesh is None else pdist.row_groups(self.mesh)
        per_row = 1 if self.mesh is None else self.mesh.axis_size(mesh_lib.SPACE)
        rows = []
        for d in range(len(everyone) // per_row):
            row = everyone[d * per_row:(d + 1) * per_row]
            mine = [i for i, s in enumerate(self.slots) if s.block.position[0] == d]
            if mine:
                ranks = list(dict.fromkeys(b.rank for b in row))
                rows.append(_Row(d, mine, row, row[0].rank, ranks, groups.get(d)))
        return rows

    def _owned(self) -> List[_Row]:
        """The rows whose first slot is this process's: it holds their FSM
        state and reports them."""
        return [r for r in self._rows if r.owner == self._process]

    # -- device functions ------------------------------------------------

    def _squares(self, frames: torch.Tensor, slot: Optional[_Slot] = None):
        """A slot's frames (its streams', (n, 3, Hf, Wf) planar or (n, Hf,
        Wf, 3) HWC u8) -> its folded blurred gray squares (n*m, H, W) u8 of
        its m squares a stream, and the change model's own blur (or None)."""
        slot = slot or self.slots[0]
        p = slot.pipe
        if slot.board_plan is None:  # one batched warp or resample for the shared plan
            squares = p.preprocess(frames)
        else:
            if tp.is_hwc(frames):  # the per-stream plans resample planar frames
                frames = frames.movedim(-1, -3)
            if p.with_enhancer:  # each board warped with its plan, all in one batch
                with tp.enhance_span():
                    padded = p._enhanced_squares(
                        mr.warp_boards_color(frames, *slot.board_plan, p._tile_index))
            else:  # each board's squares with its plan, all in one batch
                padded = mr.resample_boards_u8(planar_bgr2gray(frames)[:, None], *slot.board_plan)
                padded = padded.reshape((-1,) + tuple(padded.shape[-2:]))  # (n*64, Qr, Qc)
            squares = p.blur(padded)
        sq = slot.block.squares
        if sq == ALL_SQUARES:
            return squares

        def block(x):  # every square warped; keep this slot's block of each stream
            return None if x is None else _fold(
                x.reshape((-1, 64) + tuple(x.shape[1:]))[:, sq.start:sq.stop])

        return tuple(map(block, squares))

    def _tick_slots(self, state, inputs):
        """One tick on this process's slots: ``inputs`` one (frames, flags
        (n, 66) bool) a slot, on its device. Returns (state, outputs of the
        rows this process owns, gathered onto its first slot)."""
        pipes, noises = self._parts(state)
        new_pipes, outs = [], []
        for slot, ps, (frames, flags) in zip(self.slots, pipes, inputs):
            gray, gray_cd = self._squares(frames, slot)
            sq, n = slot.block.squares, len(slot.block.streams)
            new, out = slot.pipe._step_core(
                _map_pipe(_fold, ps),
                gray,
                flags[:, sq.start:sq.stop].reshape(-1),
                flags[:, _GIVEN].repeat_interleave(len(sq)),
                flags[:, _REFRESH].repeat_interleave(len(sq)),
                slot.consts,
                gray_change=gray_cd,
            )
            new_pipes.append(_map_pipe(lambda x: x.reshape((n, -1) + tuple(x.shape[1:])), new))
            outs.append(StepOutputs(*(x.reshape(n, -1) for x in out)))
        steps = [self._row_outputs(row, [outs[i] for i in row.slots]) for row in self._rows]
        steps = [o for o in steps if o is not None]  # the owned rows'
        new_noises, noise_outs = [], []
        for step, noise in zip(steps, noises):
            # The row's 64 squares on its first slot, which owns its FSM state.
            noise, noise_out = fsm_ops.noise_step(noise, step.visual_changes)
            new_noises.append(noise)
            noise_outs.append(noise_out)
        if not steps:  # this process owns no row: outputs of no stream
            steps = [StepOutputs(*(x.new_empty((0, 64)) for x in outs[0]))]
            noise_outs = [fsm_ops.noise_step(fsm_ops.init_state(0, device=self.device),
                                             steps[0].visual_changes)[1]]
        return (self._state(new_pipes, new_noises),
                MultiStreamOutputs(_assemble(steps, 1, self.device),
                                   _assemble(noise_outs, 1, self.device), self.rows))

    def _row_outputs(self, row: _Row, parts: list) -> Optional[StepOutputs]:
        """A row's (n, 64) StepOutputs on its first local slot's device from
        this process's square blocks ``parts``: joined where the row is
        this process's alone; for a row split over processes the other
        processes' blocks are gathered onto the owner, and the others get
        None."""
        device = self.slots[row.slots[0]].block.device
        if not row.split:
            return _assemble(parts, len(parts), device)
        # Every field packed bit for bit into one int32 buffer of the whole
        # row, this process's squares filled: one gather a tick.
        n = parts[0].occupancy.shape[0]
        buf = torch.zeros((len(StepOutputs._fields), n, 64), dtype=torch.int32, device=device)
        for i, part in zip(row.slots, parts):
            sq = self.slots[i].block.squares
            buf[:, :, sq.start:sq.stop] = torch.stack([_as_i32(x.to(device)) for x in part])
        got = pdist.row_gather(buf, row.owner, row.ranks, row.group)
        if got is None:
            return None
        for b in row.blocks:
            if b.rank != self._process:
                buf[:, :, b.squares.start:b.squares.stop] = \
                    got[b.rank][:, :, b.squares.start:b.squares.stop]
        return StepOutputs(*(_from_i32(x, like.dtype) for x, like in zip(buf, parts[0])))

    def _tick(self, state: MultiStreamState, frames: torch.Tensor, flags: torch.Tensor):
        """One tick of an unmeshed pipeline on device tensors: frames (N, 3,
        Hf, Wf) or (N, Hf, Wf, 3) u8, flags (N, 66) bool."""
        return self._tick_slots(state, [(frames, flags)])

    # -- state layout ------------------------------------------------------

    def _parts(self, state):
        """(one pipe state a slot, one noise state a row)."""
        if isinstance(state, MeshState):
            return list(state.pipe), list(state.noise)
        return [state.pipe], [state.noise]

    def _state(self, pipes, noises):
        if self.mesh is None:
            return MultiStreamState(pipes[0], noises[0])
        return MeshState(tuple(pipes), tuple(noises), _positions(s.block for s in self.slots))

    def _row_slots(self) -> List[_Slot]:
        """The first slot of each owned row, which holds its FSM state."""
        return [self.slots[r.slots[0]] for r in self._owned()]

    def replace_streams(self, state, fresh, streams):
        """``state`` with the rows of the given global streams taken from
        ``fresh``, a state of this pipeline's layout."""
        def swap(old, new, block):
            local = [s - block.streams.start for s in streams if s in block.streams]
            if not local:
                return old
            idx = torch.as_tensor(local, device=block.device)
            return tree_map(lambda o, f: o.index_copy(0, idx, f[idx]), old, new)

        (pipes, noises), (fpipes, fnoises) = self._parts(state), self._parts(fresh)
        return self._state(
            [swap(o, f, s.block) for o, f, s in zip(pipes, fpipes, self.slots)],
            [swap(o, f, s.block) for o, f, s in zip(noises, fnoises, self._row_slots())],
        )

    # -- host API --------------------------------------------------------

    def init_state(self):
        """Every stream's initial state: a MultiStreamState, on a mesh a
        MeshState (each slot's block on its device)."""
        pipes = []
        for slot in self.slots:
            sq, n = slot.block.squares, len(slot.block.streams)
            pipes.append(_map_pipe(
                lambda x: x[sq.start:sq.stop].expand((n, len(sq)) + tuple(x.shape[1:])).clone(),
                slot.pipe.init_state()))
        noises = [fsm_ops.init_state(len(s.block.streams), device=s.block.device)
                  for s in self._row_slots()]
        return self._state(pipes, noises)

    def _local(self, n_given: int) -> int:
        """The global row of the given frames' first stream: they hold all
        N streams or, on a mesh across processes, this process's
        ``frame_rows``."""
        if n_given == self.n_streams:
            return 0
        if n_given == len(self.frame_rows):
            return self.frame_rows.start
        raise ValueError(f"{n_given} streams given; this pipeline takes {self.n_streams} "
                         f"(or the {len(self.frame_rows)} of this process's rows "
                         f"{self.frame_rows.start}:{self.frame_rows.stop})")

    def _row_flags(self, flags: np.ndarray) -> np.ndarray:
        """The tick's flags with each split row's taken from its owner, so
        every process runs the row's squares on the same square masks and
        re-reference flags (the owner's games decide them)."""
        first = self._local(flags.shape[0])
        for row in self._rows:
            if row.split:
                rows = slice(row.blocks[0].streams.start - first,
                             row.blocks[0].streams.stop - first)
                got = pdist.row_broadcast(torch.from_numpy(np.ascontiguousarray(flags[rows])),
                                          row.owner, row.group,
                                          self.slots[row.slots[0]].block.device)
                flags[rows] = got.numpy()
        return flags

    def _uploads(self, frames, flags: np.ndarray, axis: int) -> list:
        """One H2D copy a slot: its streams' frames and flags (the stream
        axis is ``axis`` of both) onto its device. A tensor's rows go to
        the slot's device as they are, and only the flags are uploaded."""
        on_device = isinstance(frames, torch.Tensor)
        if not on_device:
            frames = np.asarray(frames)
        first = self._local(frames.shape[axis])
        ups = []
        for slot in self.slots:
            rows = (slice(None),) * axis + (slice(slot.block.streams.start - first,
                                                  slot.block.streams.stop - first),)
            dev = slot.block.device
            if on_device:
                _, slot_flags = tp.upload(np.zeros(0, np.uint8), flags[rows], dev)
                ups.append((tp.to_device(frames[rows], dev), slot_flags))
            else:
                ups.append(tp.upload(frames[rows], flags[rows], dev))
        return ups

    def capture_reference(self, state, frames):
        """Set every stream's visual references and change model from
        frames (N, H, W, 3) HWC or (N, 3, H, W) planar u8, host arrays or
        tensors on any device."""
        pipes, noises = self._parts(state)
        uploads = self._uploads(frames, np.zeros((len(frames), 0), bool), 0)
        new = []
        for slot, ps, (frames_d, _) in zip(self.slots, pipes, uploads):
            n = len(slot.block.streams)
            captured = slot.pipe._capture_core(_map_pipe(_fold, ps), *self._squares(frames_d, slot))
            new.append(_map_pipe(lambda x: x.reshape((n, -1) + tuple(x.shape[1:])), captured))
        return self._state(new, noises)

    def _flags(self, lead, s2c_masks=None, refresh=None, n=None) -> np.ndarray:
        n = self.n_streams if n is None else n
        flags = np.zeros(lead + (n, _FLAGS), bool)
        if s2c_masks is not None:
            flags[..., :64] = np.asarray(s2c_masks, bool).reshape(n, 64)
            flags[..., _GIVEN] = True
        if refresh is not None:
            flags[..., _REFRESH] = np.asarray(refresh, bool).reshape(n)
        return flags

    def step(self, state, frames, s2c_masks=None, refresh=None):
        """One tick for all N streams (or this process's, on a mesh across
        processes). frames: (N, H, W, 3) HWC or (N, 3, H, W) planar u8, a
        host array or a tensor on any device; s2c_masks: optional (N, 64)
        bool squares to force a fresh detection on; refresh: optional (N,)
        bool forced re-reference per stream. Returns (state,
        MultiStreamOutputs on the device)."""
        with span("pipeline.step"):
            flags = self._row_flags(self._flags((), s2c_masks, refresh, np.shape(frames)[0]))
            inputs = self._uploads(frames, flags, 0)
            with span("pipeline.enqueue"), tp.resample_count():
                return self._tick_slots(state, inputs)

    def step_chunk(self, state, frames):
        """T ticks for all N streams from one upload a slot: frames (T, N, H,
        W, 3) or (T, N, 3, H, W) u8, a host array or a tensor on any device
        (a buffer already on the slots' device is read in place). Outputs
        have leading (T, N) axes; tick semantics equal T sequential
        ``step`` calls (no squares_to_check, no refresh)."""
        t_len, n = np.shape(frames)[:2]
        ups = self._uploads(frames, self._flags((t_len,), n=n), 1)
        outs = []
        for i in range(t_len):
            state, out = self._tick_slots(state, [(f[i], g[i]) for f, g in ups])
            outs.append(out)
        return state, _stack(outs)


def outputs_to_numpy(out: MultiStreamOutputs) -> MultiStreamOutputs:
    """Device MultiStreamOutputs (any leading axes) -> host numpy, in one
    D2H copy."""
    host = tp.leaves_to_numpy([*out.step, *out.noise])
    k = len(out.step)
    return MultiStreamOutputs(StepOutputs(*host[:k]), fsm_ops.NoiseFsmOut(*host[k:]), out.streams)


def multistream_state_from_numpy(tree, device=None, mesh: Optional[mesh_lib.StreamMesh] = None):
    """A MultiStreamState-shaped tree of arrays (e.g. the JAX package's
    state, leaves through ``np.asarray``: a meshed JAX state too) -> the
    port's state: on ``device`` (the card unless the caller asks for the
    CPU), or with ``mesh`` scattered over its slots as a meshed pipeline of
    the tree's N streams holds it (a MeshState). Leaves are matched by
    field name."""
    def named(cls, node):
        return cls(**{name: np.asarray(getattr(node, name)) for name in cls._fields})

    noise = named(fsm_ops.NoiseFsmState, tree.noise)
    if mesh is not None:
        pipe = PipelineState(named(pd_model.PieceState, tree.pipe.piece),
                             named(change_ops.ChangeModelState, tree.pipe.change))
        blocks = mesh_lib.stream_square_sharding(mesh).local_blocks(len(noise.mode))
        if device is not None and mesh_lib.slot_device(device) != blocks[0].device:
            raise ValueError(f"device {str(device)!r} disagrees with the mesh's first slot "
                             f"{blocks[0].device}")
        # The noise state of a row on its first slot: the rows this process owns.
        noises = [x for x, b in zip(mesh_lib.shard_pytree_leading_axis(noise, mesh), blocks)
                  if b.position[1] == 0]
        return MeshState(tuple(mesh_lib.shard_pytree_stream_square(pipe, mesh)), tuple(noises),
                         _positions(blocks))
    device = resolve_device("cuda" if device is None else device, "multistream_state_from_numpy")
    return MultiStreamState(
        pipe=tp.state_from_numpy(tree.pipe, device=device),
        noise=fsm_ops.NoiseFsmState(*(torch.as_tensor(np.array(x), device=device) for x in noise)),
    )


def multistream_state_to_numpy(state) -> MultiStreamState:
    """The port's state -> a MultiStreamState with host numpy leaves (N,
    ...); a MeshState is gathered from its slots (on a mesh across
    processes: the rows this process owns, each of which it must hold
    whole: a row split over processes raises)."""
    if isinstance(state, MeshState):
        cpu = torch.device("cpu")
        rows = {}
        for (d, q0, q1), pipe in zip(state.blocks, state.pipe):
            rows.setdefault(d, []).append((q0, q1, pipe))
        owned = [parts for parts in rows.values() if parts[0][0] == 0]
        for parts in owned:
            if [q for q0, q1, _ in parts for q in range(q0, q1)] != list(ALL_SQUARES):
                raise ValueError("multistream_state_to_numpy: a data row of this state is "
                                 "split over processes; its other squares are held elsewhere")
        pipes = [_assemble([p for _, _, p in parts], len(parts), cpu) for parts in owned]
        state = MultiStreamState(_assemble(pipes, 1, cpu), _assemble(list(state.noise), 1, cpu))
    return MultiStreamState(
        pipe=tp.state_to_numpy(state.pipe),
        noise=fsm_ops.NoiseFsmState(*(x.cpu().numpy() for x in state.noise)),
    )
