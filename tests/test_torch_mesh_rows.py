"""A data row of the port's stream mesh split over processes, on the CPU.

The mesh is data 3 x space 2 over 6 slots, 6 streams: two processes of 3
slots each, process-major (parallel/distributed.global_stream_mesh's
order), so row 1's two space slots belong to different processes. Process
0 owns rows 0 and 1 (streams 0-3: row 1's first slot is its own), process
1 owns row 2 (streams 4-5) and also runs row 1's second square block, so
it takes the frames of streams 2-5. Each tick process 1 receives row 1's
flags from process 0 and sends it its block's outputs.

- In one process, the two ranks run as two threads, their row exchange
  through a stand-in for the torch.distributed calls it makes
  (``ThreadGroup``): each rank's owned rows must equal the JAX package's
  single-process meshed run over 6 of the 8 forced CPU devices (bool/i32
  exactly, f32 within tests/test_torch_pipeline.py's F32_RTOL/F32_ATOL),
  also from a JAX meshed state scattered with
  multistream_state_from_numpy(mesh=), and after replace_streams across
  the split row equal to the unmeshed port given the same replacement.
  Process 1 is given wrong square masks for the rows it does not own: the
  owner's must win.
- A 4-game MultiStreamSession on a 2 x 2 mesh split as [0, 1, 1, 1]
  commits the JAX meshed session's moves on the same ticks.
- A real two-process Gloo fleet through ``dryrun_multigpu --fleet-worker``
  on the 3 x 2 layout: each worker prints FLEET-OK with its owned rows
  equal to the JAX reference over two ticks (every StepOutputs and FSM
  field), every wait with a timeout of its own.
"""

import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from chessboard_vision_tpu.parallel import make_mesh as jax_make_mesh
from chessboard_vision_tpu.parallel.multistream import MultiStreamPipeline as JaxMulti
from chessboard_vision_tpu_torch.models import pipeline as tp
from chessboard_vision_tpu_torch.ops import fsm as tfsm
from chessboard_vision_tpu_torch.ops.layout import positions_to_mask
from chessboard_vision_tpu_torch.parallel import distributed as pdist
from chessboard_vision_tpu_torch.parallel import multistream as tms
from chessboard_vision_tpu_torch.parallel.mesh import StreamMesh
from chessboard_vision_tpu_torch.parallel.session import MultiStreamSession as TorchSession
from chessboard_vision_tpu_torch.tools import dryrun_multigpu

import fleet_fixture as ff
from test_torch_distributed import ENV_VARS, REPO, WORKER_TIMEOUT_S, _free_port
from test_torch_mesh import _geos, _run, _sequence, _session, _session_frames
from test_torch_multistream import assert_multi_match
from test_torch_pipeline import EXACT, F32_ATOL, F32_RTOL

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

N = 6
SHAPE = (3, 2)
RANKS = [0, 0, 0, 1, 1, 1]
OWNED = {0: range(0, 4), 1: range(4, 6)}
FRAME_ROWS = {0: range(0, 4), 1: range(2, 6)}
WAIT_S = 60


class ThreadGroup:
    """The torch.distributed calls of the row exchange (parallel/
    distributed.py) for ranks run as threads of one process: each group a
    barrier, each collective's tensors handed over in memory."""

    def __init__(self):
        self._rank = threading.local()
        self._barriers, self._boxes = {}, {}
        self._lock = threading.Lock()

    def run_as(self, rank):
        self._rank.value = rank

    def is_initialized(self):
        return True

    def get_rank(self, group=None):
        return self._rank.value

    def get_backend(self, group=None):
        return "gloo"

    def new_group(self, ranks, timeout=None):
        key = tuple(sorted(ranks))
        with self._lock:
            self._barriers.setdefault(key, threading.Barrier(len(key), timeout=WAIT_S))
            self._boxes.setdefault(key, {})
        return key

    def gather(self, tensor, gather_list=None, dst=0, group=None):
        box, barrier = self._boxes[group], self._barriers[group]
        box[self._rank.value] = tensor.clone()
        barrier.wait()
        if self._rank.value == dst:
            for buf, r in zip(gather_list, group):
                buf.copy_(box[r])
        barrier.wait()

    def broadcast(self, tensor, src, group=None):
        box, barrier = self._boxes[group], self._barriers[group]
        if self._rank.value == src:
            box["broadcast"] = tensor.clone()
        barrier.wait()
        if self._rank.value != src:
            tensor.copy_(box["broadcast"])
        barrier.wait()


@pytest.fixture
def group(monkeypatch):
    fake = ThreadGroup()
    monkeypatch.setattr(pdist, "dist", fake)
    return fake


def _mesh(process, ranks=RANKS, shape=SHAPE):
    return StreamMesh(["cpu"] * len(ranks), ("data", "space"), shape, ranks=ranks,
                      process=process)


def _as_ranks(group, fn, ranks=(0, 1)):
    """fn(rank) on a thread a rank; their results by rank."""
    def body(rank):
        group.run_as(rank)
        return fn(rank)

    with ThreadPoolExecutor(len(ranks)) as pool:
        return dict(zip(ranks, pool.map(body, ranks)))


def _jax_rows(out, rows):
    """The given rows of JAX MultiStreamOutputs, as host arrays."""
    return type(out)(
        type(out.step)(*(np.asarray(x)[rows.start:rows.stop] for x in out.step)),
        type(out.noise)(*(np.asarray(x)[rows.start:rows.stop] for x in out.noise)),
    )


def _wrong_foreign(masks, rank):
    """The masks a rank is given for its frame rows: those of the rows it
    does not own inverted (the owner's must win)."""
    if masks is None:
        return None
    rows = FRAME_ROWS[rank]
    given = np.asarray(masks)[rows.start:rows.stop].copy()
    foreign = [i - rows.start for i in rows if i not in OWNED[rank]]
    given[foreign] = ~given[foreign]
    return given


def _run_rank(ms, ref, ticks, rank, state=None):
    rows = FRAME_ROWS[rank]
    if state is None:
        state = ms.capture_reference(ms.init_state(), ref[rows.start:rows.stop])
    outs = []
    for frames, masks, refresh in ticks:
        state, out = ms.step(state, frames[rows.start:rows.stop],
                             s2c_masks=_wrong_foreign(masks, rank),
                             refresh=None if refresh is None else refresh[rows.start:rows.stop])
        outs.append(out)
    return state, outs


def _jax_reference(seed):
    jg, _ = _geos()
    jm = JaxMulti(jg, n_streams=N, mesh=jax_make_mesh(N, ("data", "space"), SHAPE),
                  hough_backend="conv")
    ref, ticks = _sequence(seed, N)
    return jm, ref, ticks


def test_split_row_ranks_match_jax_meshed_run(group):
    """Both ranks through capture and 3 ticks (square masks and
    re-reference flags that differ per stream): each rank's owned rows
    equal the JAX meshed run's; the state keeps each rank's slots and
    the FSM of its owned rows."""
    jm, ref, ticks = _jax_reference(41)
    _, jouts = _run(jm, ref, ticks)
    _, tg = _geos()

    def rank_run(rank):
        ms = tms.MultiStreamPipeline(tg, N, mesh=_mesh(rank), hough_backend="conv")
        assert ms.rows == OWNED[rank] and ms.frame_rows == FRAME_ROWS[rank]
        state, outs = _run_rank(ms, ref, ticks, rank)
        return ms, state, outs

    got = _as_ranks(group, rank_run)
    for rank, (ms, state, outs) in got.items():
        assert isinstance(state, tms.MeshState) and len(state.pipe) == 3
        assert len(state.noise) == len(OWNED[rank]) // 2
        for t, (to, jo) in enumerate(zip(outs, jouts)):
            assert to.streams == OWNED[rank]
            assert_multi_match(to, _jax_rows(jo, OWNED[rank]), where=f"rank {rank} tick {t}")
        if rank == 0:  # it owns the split row, whose second block is rank 1's
            with pytest.raises(ValueError, match="split over processes"):
                tms.multistream_state_to_numpy(state)
        else:  # the rows it owns, whole
            assert tms.multistream_state_to_numpy(state).noise.mode.shape == (2,)


def test_split_row_state_from_numpy_and_replace_streams(group):
    """A JAX meshed mid-sequence state scattered onto each rank with
    multistream_state_from_numpy(mesh=) steps to the JAX outputs; then
    streams 2 and 4 (2 in the split row) take a fresh capture with
    replace_streams, and the next tick equals the unmeshed port given the
    same replacement."""
    jm, ref, ticks = _jax_reference(42)
    js = jm.capture_reference(jm.init_state(), ref)
    js, _ = jm.step(js, ticks[0][0])
    host = jax.tree.map(np.asarray, js)
    js, jo = jm.step(js, ticks[1][0], s2c_masks=ticks[1][1], refresh=ticks[1][2])
    _, tg = _geos()
    um = tms.MultiStreamPipeline(tg, N, hough_backend="conv", device="cpu")
    us = tms.multistream_state_from_numpy(host, device="cpu")
    us, _ = um.step(us, ticks[1][0], s2c_masks=ticks[1][1], refresh=ticks[1][2])
    fresh_frames = ticks[2][0]
    us = um.replace_streams(us, um.capture_reference(um.init_state(), fresh_frames), [2, 4])
    us, uo = um.step(us, ticks[2][0], s2c_masks=ticks[2][1])

    def rank_run(rank):
        mesh = _mesh(rank)
        ms = tms.MultiStreamPipeline(tg, N, mesh=mesh, hough_backend="conv")
        state = tms.multistream_state_from_numpy(host, mesh=mesh)
        assert len(state.pipe) == 3 and len(state.noise) == len(OWNED[rank]) // 2
        rows = FRAME_ROWS[rank]
        state, (first,) = _run_rank(ms, ref, [ticks[1]], rank, state)
        fresh = ms.capture_reference(ms.init_state(), fresh_frames[rows.start:rows.stop])
        state = ms.replace_streams(state, fresh, [2, 4])
        _, (second,) = _run_rank(ms, ref, [ticks[2]], rank, state)
        return first, second

    for rank, (first, second) in _as_ranks(group, rank_run).items():
        rows = OWNED[rank]
        assert_multi_match(first, _jax_rows(jo, rows), where=f"rank {rank} from JAX state")
        a, b = tms.outputs_to_numpy(second), tms.outputs_to_numpy(uo)
        for f in tp.StepOutputs._fields:
            x, y = getattr(a.step, f), getattr(b.step, f)[rows.start:rows.stop]
            if f in EXACT:
                np.testing.assert_array_equal(x, y, err_msg=f"rank {rank} {f}")
            else:
                np.testing.assert_allclose(x, y, rtol=F32_RTOL, atol=F32_ATOL, err_msg=f)
        for f in tfsm.NoiseFsmOut._fields:
            np.testing.assert_array_equal(getattr(a.noise, f),
                                          getattr(b.noise, f)[rows.start:rows.stop])


def test_split_row_session_commits_the_jax_meshed_sessions_moves(group):
    """4 games on a 2 x 2 mesh whose row 0 is split ([0, 1, 1, 1]: rank 0
    owns games 0-1 from one slot, rank 1 games 2-3 and row 0's second
    block): each rank's session commits the JAX meshed session's moves of
    its games on the same ticks and reaches their FENs."""
    boards, ref, ticks = _session_frames(43)
    jax_sess = _session("jax")
    jax_sess.capture_reference(ref)
    want = [[m and m.uci() for m in jax_sess.on_frames(fr)] for fr in ticks]
    _, tg = _geos()
    ranks = [0, 1, 1, 1]
    frame_rows = {0: range(0, 2), 1: range(0, 4)}

    def rank_run(rank):
        sess = TorchSession(tg, n_streams=4, hough_backend="conv",
                            mesh=_mesh(rank, ranks, (2, 2)))
        sess.MOVE_COOLDOWN, sess.STABILITY_REQUIRED = 0.0, 4
        assert sess.ms.frame_rows == frame_rows[rank]
        rows = frame_rows[rank]
        sess.capture_reference(ref[rows.start:rows.stop])
        got = [[m and m.uci() for m in sess.on_frames(fr[rows.start:rows.stop])]
               for fr in ticks]
        return sess.rows, got, [sess.streams[i].game.get_fen() for i in sess.rows]

    for rank, (rows, got, fens) in _as_ranks(group, rank_run).items():
        assert rows == (range(0, 2) if rank == 0 else range(2, 4))
        assert got == [t[rows.start:rows.stop] for t in want], rank
        assert fens == [boards[i].fen() for i in rows]


def test_a_rank_that_owns_no_row(group):
    """A 1 x 2 mesh over two ranks: rank 0 owns the one row, rank 1 runs
    its second square block, reports no stream (outputs of 0 rows) and
    holds no FSM state; rank 0's outputs equal the unmeshed port's."""
    _, tg = _geos()
    ref, ticks = _sequence(44, 2)
    um = tms.MultiStreamPipeline(tg, 2, hough_backend="conv", device="cpu")
    _, uouts = _run(um, ref, ticks)

    def rank_run(rank):
        ms = tms.MultiStreamPipeline(tg, 2, mesh=_mesh(rank, [0, 1], (1, 2)),
                                     hough_backend="conv")
        state, outs = _run(ms, ref, ticks)
        return ms, state, outs

    got = _as_ranks(group, rank_run)
    ms, state, outs = got[1]
    assert ms.rows == range(0, 0) and ms.frame_rows == range(0, 2) and state.noise == ()
    for out in outs:
        host = tms.outputs_to_numpy(out)
        assert host.step.occupancy.shape == (0, 64) and host.noise.squares.shape == (0, 64)
        assert host.noise.mode.shape == (0,) and out.streams == range(0, 0)
    for t, (to, uo) in enumerate(zip(got[0][2], uouts)):
        a, b = tms.outputs_to_numpy(to), tms.outputs_to_numpy(uo)
        for f in tp.StepOutputs._fields:
            x, y = getattr(a.step, f), getattr(b.step, f)
            if f in EXACT:
                np.testing.assert_array_equal(x, y, err_msg=f"tick {t} {f}")
            else:
                np.testing.assert_allclose(x, y, rtol=F32_RTOL, atol=F32_ATOL, err_msg=f)
        for f in tfsm.NoiseFsmOut._fields:
            np.testing.assert_array_equal(getattr(a.noise, f), getattr(b.noise, f))


def test_split_row_needs_a_process_group():
    """Without a torch.distributed group a mesh that splits a row over
    processes raises, naming init_distributed."""
    _, tg = _geos()
    with pytest.raises(ValueError, match="init_distributed"):
        tms.MultiStreamPipeline(tg, N, mesh=_mesh(0), hough_backend="conv")


def test_two_process_gloo_fleet_split_row(tmp_path):
    """Two fleet workers over Gloo on the CPU, 3 slots each on the data 3 x
    space 2 mesh: each rank's owned rows of two ticks (the second with
    square masks, given wrong for the rows it does not own) equal the JAX
    package's single-process meshed run in every StepOutputs and FSM
    field."""
    jg, tg = _geos()
    refs = np.stack([ff.stream_frames(gi)[0] for gi in range(N)])
    steps = np.stack([ff.stream_frames(gi)[1] for gi in range(N)])
    masks = np.stack([positions_to_mask({(s % 8, 1), (s % 8, 2), (0, 0)}) for s in range(N)])
    # The workers' backend is "auto": exact on the CPU, as the JAX package's off its TPU.
    jm = JaxMulti(jg, n_streams=N, mesh=jax_make_mesh(N, ("data", "space"), SHAPE))
    js = jm.capture_reference(jm.init_state(), refs)
    js, j0 = jm.step(js, steps)
    js, j1 = jm.step(js, steps, s2c_masks=masks)
    expected = {"occ": np.asarray(j0.step.occupancy), "rtol": F32_RTOL, "atol": F32_ATOL}
    for t, jo in enumerate((j0, j1)):
        for f in jo.step._fields:
            expected[f"t{t}_{f}"] = np.asarray(getattr(jo.step, f))
        for f in jo.noise._fields:
            expected[f"t{t}_noise_{f}"] = np.asarray(getattr(jo.noise, f))
    for gi in range(N):
        assert not expected["occ"][gi, 8 + gi % 8], f"stream {gi}: pawn still seen"
    frames_path, expected_path = str(tmp_path / "fleet.npz"), str(tmp_path / "expected.npz")
    dryrun_multigpu.save_fleet(frames_path, refs, steps, tg, ff.MARGIN, 3, shape=SHAPE,
                               masks=masks)
    np.savez(expected_path, **expected)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ENV_VARS}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "chessboard_vision_tpu_torch.tools.dryrun_multigpu",
         "--fleet-worker", str(rank), "2", str(port), frames_path, expected_path,
         "--device", "cpu", "--backend", "gloo"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    n_expected = 2 * (len(tp.StepOutputs._fields) + len(tfsm.NoiseFsmOut._fields))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        rows = OWNED[rank]
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"FLEET-OK rank={rank} streams={rows.start}:{rows.stop} of {N}" in out, out
        assert f"{n_expected} expected arrays equal" in out, out
