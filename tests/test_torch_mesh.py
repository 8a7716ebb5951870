"""The port's stream mesh against the JAX package's, on the CPU.

The JAX meshed MultiStreamPipeline runs on tests/conftest.py's 8 virtual
CPU devices (``make_mesh(8, ...)``); the port's runs on an explicit slot
list that names the CPU eight times (``make_mesh(8, devices=["cpu"] * 8)``),
so its sharding, per-slot cores and gathers all run. Both see the same
320x240 frames (tests/fleet_fixture.py's rig: a 160 px board of 20 px
squares) from a numpy seed and start from the same state. StepOutputs and
NoiseFsmOut must agree: bool/i32 fields exactly, f32 fields within
tests/test_torch_pipeline.py's F32_RTOL/F32_ATOL (on the CPU the plain
score matmul rounds in the last bits by width, ROADMAP Queue C 11, and
each slot's width differs from N*64). Both sides name the Hough backend.

The JAX meshed enhanced pipeline cannot run its Pallas kernels in
interpret mode (XLA's SPMD partitioner refuses the interpreter's
io_callback under a replicated sharding, and vmap of the interpreted
kernels reads out of bounds), so the port's enhanced mesh is held to the
JAX meshed pipeline (its CPU stand-ins) on the bool/i32 fields and to the
JAX single-stream pipeline with its Pallas kernels in interpret mode on
every field, as the enhanced parity tests of tests/test_torch_pipeline.py
hold the single-stream port.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chessboard_vision_tpu import geometry as jgeo
from chessboard_vision_tpu.models.pipeline import VisionPipeline as JaxPipeline
from chessboard_vision_tpu.ops import enhance as jax_enhance
from chessboard_vision_tpu.parallel import make_mesh as jax_make_mesh
from chessboard_vision_tpu.parallel.multistream import MultiStreamPipeline as JaxMulti
from chessboard_vision_tpu.parallel.session import MultiStreamSession as JaxSession
from chessboard_vision_tpu_torch import geometry as tgeo
from chessboard_vision_tpu_torch.models import pipeline as tp
from chessboard_vision_tpu_torch.ops import fsm as tfsm
from chessboard_vision_tpu_torch.ops.layout import positions_to_mask, to_planar
from chessboard_vision_tpu_torch.parallel import MultiStreamSession as TorchSession
from chessboard_vision_tpu_torch.parallel import make_mesh
from chessboard_vision_tpu_torch.parallel import multistream as tms
from chessboard_vision_tpu_torch.rules import chess
from chessboard_vision_tpu_torch.tools.demo_pipeline import occupancy_of
from chessboard_vision_tpu_torch.utils import checkpoint as tckpt

import fleet_fixture as ff
from fixtures import initial_occupancy, make_board_frame
from test_torch_multistream import assert_multi_match, assert_multi_states_match
from test_torch_pipeline import ENHANCED_MEAN_ATOL, EXACT, F32_ATOL, F32_RTOL

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
SHIFT = np.array([[3, 2]] * 4)  # a second rig's corners: the camera moved by (3, 2) px
PROFILE = {"contrast": 1.1, "brightness": 4}
ALL = {(f, r) for f in range(8) for r in range(8)}


def _geos(corners=ff.FLEET_CORNERS, display_size=ff.DISPLAY_SIZE, margin=ff.MARGIN):
    return (jgeo.BoardGeometry.from_calibration(corners, display_size=display_size,
                                                margin=margin),
            tgeo.BoardGeometry.from_calibration(corners, display_size=display_size,
                                                margin=margin))


def _moved(s):
    """Stream s's position: its pawn of file s % 8 two squares up."""
    occ = initial_occupancy()
    occ[s % 8, 1], occ[s % 8, 3] = False, True
    return occ


def _frames(rng, occs, corners=None, frame_size=ff.FRAME_SIZE):
    corners = corners or [ff.FLEET_CORNERS] * len(occs)
    return np.stack([to_planar(make_board_frame(o, rng, corners=c, frame_size=frame_size))
                     for o, c in zip(occs, corners)])


def _sequence(seed, n, corners=None):
    """(reference frames, ticks of (frames, s2c masks or None, refresh or
    None)): the start position, then each stream's own pawn move, with
    square masks and re-reference flags that differ per stream."""
    rng = np.random.default_rng(seed)
    start, moved = [initial_occupancy()] * n, [_moved(s) for s in range(n)]
    smart = np.stack([positions_to_mask({(s % 8, 1), (s % 8, 3), (0, 0)}) for s in range(n)])
    ticks = [(_frames(rng, start, corners), None, None),
             (_frames(rng, moved, corners), np.ones((n, 64), bool), np.arange(n) % 3 == 1),
             (_frames(rng, moved, corners), smart, None)]
    return _frames(rng, start, corners), ticks


def _run(ms, ref, ticks):
    state = ms.capture_reference(ms.init_state(), ref)
    outs = []
    for frames, masks, refresh in ticks:
        state, out = ms.step(state, frames, s2c_masks=masks, refresh=refresh)
        outs.append(out)
    return state, outs


def _assert_moves_seen(out, n):
    """Each stream's fresh detection shows its own pawn move (its square
    left empty, its target taken): a stream mixed up with another shows
    another file's."""
    raw = tms.outputs_to_numpy(out).step.raw_occupancy
    for s in range(n):
        assert not raw[s, 8 + s % 8] and raw[s, 24 + s % 8], s


def _mesh_vs_jax(seed, n, jmesh, tmesh, geos=None, backend="conv"):
    """The JAX and the port's meshed pipelines through one sequence:
    every tick's outputs and the final (gathered) state agree."""
    corners = None if geos is None else geos
    jg = [_geos(c)[0] for c in geos] if geos else _geos()[0]
    tg = [_geos(c)[1] for c in geos] if geos else _geos()[1]
    jm = JaxMulti(jg, n_streams=n, mesh=jmesh, hough_backend=backend)
    tm = tms.MultiStreamPipeline(tg, n, mesh=tmesh, hough_backend=backend)
    ref, ticks = _sequence(seed, n, corners)
    js, jouts = _run(jm, ref, ticks)
    ts, touts = _run(tm, ref, ticks)
    for t, (to, jo) in enumerate(zip(touts, jouts)):
        assert to.streams == range(n)
        assert_multi_match(to, jo, where=f"tick {t}")
    assert_multi_states_match(ts, js)
    _assert_moves_seen(touts[-1], n)
    return tm, ts, touts


@pytest.mark.parametrize("backend", ["conv", "exact"])
def test_dp_mesh_matches_jax_dp_mesh(backend):
    """8 streams on the dp mesh of 8 slots, one stream a slot."""
    tm, ts, _ = _mesh_vs_jax(31, 8, jax_make_mesh(8), make_mesh(8, devices=CPU8),
                             backend=backend)
    assert isinstance(ts, tms.MeshState) and len(ts.pipe) == len(ts.noise) == 8


def test_dp_sp_mesh_matches_jax_dp_sp_mesh():
    """8 streams on the 4 x 2 mesh: two streams and 32 squares a slot, the
    noise FSM of a row on its first slot."""
    tm, ts, _ = _mesh_vs_jax(32, 8, jax_make_mesh(8, ("data", "space"), (4, 2)),
                             make_mesh(8, ("data", "space"), (4, 2), devices=CPU8))
    assert len(ts.pipe) == 8 and len(ts.noise) == 4
    for slot, pipe in zip(tm.slots, ts.pipe):
        assert slot.block.squares == range(32 * slot.block.position[1],
                                           32 * (slot.block.position[1] + 1))
        assert pipe.piece.has_ref.shape == (2, 32) and pipe.change.means.shape[:2] == (2, 32)
        assert slot.consts.conv_plan.kvalid.shape[1] == 64  # 2 streams x 32 squares
    assert all(noise.pending.shape == (2, 64) for noise in ts.noise)


def test_per_stream_geometry_dp_mesh_matches_jax():
    """8 rigs, the odd ones' corners shifted, on the dp mesh of 8 slots:
    each slot resamples its stream with its rig's plan."""
    corners = [ff.FLEET_CORNERS + (SHIFT if s % 2 else 0) for s in range(8)]
    tm, _, _ = _mesh_vs_jax(33, 8, jax_make_mesh(8), make_mesh(8, devices=CPU8), geos=corners)
    assert all(slot.board_plan[0].src_index.shape[0] == 1 for slot in tm.slots)  # one rig a slot


def test_enhanced_dp_mesh_matches_jax(monkeypatch):
    """with_enhancer=True, 4 streams on a dp mesh of 4 slots: bool/i32
    outputs equal the JAX meshed enhanced pipeline's, and every output
    equals the JAX single-stream enhanced pipeline's with its Pallas
    kernels in interpret mode (the squares' means within
    tests/test_torch_pipeline.py's ENHANCED_MEAN_ATOL)."""
    n = 4
    jg, tg = _geos()
    rng = np.random.default_rng(34)
    ref = _frames(rng, [initial_occupancy()] * n)
    frames = _frames(rng, [_moved(s) for s in range(n)])
    jm = JaxMulti(jg, n_streams=n, mesh=jax_make_mesh(n), with_enhancer=True,
                  enhancer_profile=PROFILE, hough_backend="conv")
    tm = tms.MultiStreamPipeline(tg, n, mesh=make_mesh(n, devices=["cpu"] * n),
                                 with_enhancer=True, enhancer_profile=PROFILE,
                                 hough_backend="conv")
    masks = np.ones((n, 64), bool)
    js, jo = jm.step(jm.capture_reference(jm.init_state(), ref), frames, s2c_masks=masks)
    ts, to = tm.step(tm.capture_reference(tm.init_state(), ref), frames, s2c_masks=masks)
    host = tms.outputs_to_numpy(to)
    for f in EXACT:
        np.testing.assert_array_equal(getattr(host.step, f), np.asarray(getattr(jo.step, f)),
                                      err_msg=f)
    for f in tfsm.NoiseFsmOut._fields:
        np.testing.assert_array_equal(getattr(host.noise, f), np.asarray(getattr(jo.noise, f)))
    monkeypatch.setattr(jax_enhance, "clahe",
                        functools.partial(jax_enhance.clahe, backend="pallas"))
    with pltpu.force_tpu_interpret_mode():
        jp = JaxPipeline(jg, hough_backend="conv", with_enhancer=True, enhancer_profile=PROFILE,
                         bilateral_backend="pallas", donate_state=False)
        for s in range(n):
            st = jp.capture_reference(jp.init_state(), ref[s])
            st, o = jp.step(st, frames[s], squares_to_check=ALL)
            for f in tp.StepOutputs._fields:
                got, want = getattr(host.step, f)[s], np.asarray(getattr(o, f))
                if f in EXACT:
                    np.testing.assert_array_equal(got, want, err_msg=f"stream {s} {f}")
                else:
                    atol = ENHANCED_MEAN_ATOL if f in ("center_mean", "corner_mean") else F32_ATOL
                    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=atol,
                                               err_msg=f"stream {s} {f}")


def test_step_chunk_on_mesh_matches_jax_and_sequential_ticks():
    """step_chunk(T=3) on the 4 x 2 mesh equals the JAX meshed step_chunk
    and, exactly, 3 sequential ticks of the port's mesh."""
    jg, tg = _geos()
    jm = JaxMulti(jg, n_streams=8, mesh=jax_make_mesh(8, ("data", "space"), (4, 2)),
                  hough_backend="conv")
    tmesh = make_mesh(8, ("data", "space"), (4, 2), devices=CPU8)
    tm = tms.MultiStreamPipeline(tg, 8, mesh=tmesh, hough_backend="conv")
    ref, ticks = _sequence(35, 8)
    chunk = np.stack([frames for frames, _, _ in ticks])
    js = jm.capture_reference(jm.init_state(), ref)
    ts = tm.capture_reference(tm.init_state(), ref)
    seq = tms.multistream_state_from_numpy(tms.multistream_state_to_numpy(ts), mesh=tmesh)
    js, jo = jm.step_chunk(js, chunk)
    ts, to = tm.step_chunk(ts, chunk)
    assert to.step.occupancy.shape == (3, 8, 64) and to.noise.mode.shape == (3, 8)
    assert_multi_match(to, jo, where="chunk")
    assert_multi_states_match(ts, js)
    many = tms.outputs_to_numpy(to)
    for t in range(3):
        seq, o = tm.step(seq, chunk[t])
        o = tms.outputs_to_numpy(o)
        for part in ("step", "noise"):
            for f in getattr(o, part)._fields:
                np.testing.assert_array_equal(getattr(getattr(many, part), f)[t],
                                              getattr(getattr(o, part), f), err_msg=f"{t} {f}")
    for a, b in zip(tckpt.tree_leaves(tms.multistream_state_to_numpy(seq)),
                    tckpt.tree_leaves(tms.multistream_state_to_numpy(ts))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_meshed_port_matches_unmeshed_port(shape):
    """The port's meshed pipeline against its own unmeshed one on every
    tick and on the gathered state, so a slicing fault cannot hide behind
    the JAX package being equally wrong; every slot holds n/dp streams and
    64/sp squares, and one base pipeline serves every slot of a device."""
    dp, sp = shape
    n = 8
    _, tg = _geos()
    mesh = make_mesh(8, ("data", "space"), shape, devices=CPU8)
    ref, ticks = _sequence(36, n)
    tm = tms.MultiStreamPipeline(tg, n, mesh=mesh, hough_backend="conv")
    um = tms.MultiStreamPipeline(tg, n, hough_backend="conv", device="cpu")
    assert len({id(s.pipe) for s in tm.slots}) == 1
    ts, touts = _run(tm, ref, ticks)
    us, uouts = _run(um, ref, ticks)
    for t, (to, uo) in enumerate(zip(touts, uouts)):
        a, b = tms.outputs_to_numpy(to), tms.outputs_to_numpy(uo)
        for f in tp.StepOutputs._fields:
            x, y = getattr(a.step, f), getattr(b.step, f)
            if f in EXACT:
                np.testing.assert_array_equal(x, y, err_msg=f"tick {t} {f}")
            else:
                np.testing.assert_allclose(x, y, rtol=F32_RTOL, atol=F32_ATOL, err_msg=f)
        for f in tfsm.NoiseFsmOut._fields:
            np.testing.assert_array_equal(getattr(a.noise, f), getattr(b.noise, f))
    for path, (x, y) in enumerate(zip(tckpt.tree_leaves(tms.multistream_state_to_numpy(ts)),
                                      tckpt.tree_leaves(tms.multistream_state_to_numpy(us)))):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_allclose(x, y, rtol=F32_RTOL, atol=F32_ATOL, err_msg=str(path))
    for slot, pipe in zip(tm.slots, ts.pipe):
        d, k = slot.block.position
        assert slot.block.streams == range(d * n // dp, (d + 1) * n // dp)
        assert slot.block.squares == range(k * 64 // sp, (k + 1) * 64 // sp)
        assert pipe.piece.ref_gray.shape[:2] == (n // dp, 64 // sp)
    assert [tuple(x.shape) for x in ts.noise[0]] == [(n // dp,), (n // dp, 64), (n // dp,),
                                                     (n // dp,), (n // dp,)]


def test_jax_meshed_state_scatters_onto_the_port_mesh():
    """A JAX meshed mid-sequence state (leaves through np.asarray)
    scattered with multistream_state_from_numpy(mesh=...) steps to the JAX
    outputs; gathering it back is lossless."""
    jg, tg = _geos()
    jm = JaxMulti(jg, n_streams=8, mesh=jax_make_mesh(8, ("data", "space"), (4, 2)),
                  hough_backend="conv")
    tmesh = make_mesh(8, ("data", "space"), (4, 2), devices=CPU8)
    tm = tms.MultiStreamPipeline(tg, 8, mesh=tmesh, hough_backend="conv")
    ref, ticks = _sequence(37, 8)
    js = jm.capture_reference(jm.init_state(), ref)
    js, _ = jm.step(js, ticks[1][0], s2c_masks=ticks[1][1])
    host = jax.tree.map(np.asarray, js)
    ts = tms.multistream_state_from_numpy(host, mesh=tmesh)
    assert isinstance(ts, tms.MeshState) and ts.pipe[3].piece.has_ref.shape == (2, 32)
    for a, b in zip(tckpt.tree_leaves(tms.multistream_state_to_numpy(ts)),
                    jax.tree.leaves(host)):
        np.testing.assert_array_equal(a, b)
    frames, masks, _ = ticks[2]
    js, jo = jm.step(js, frames, s2c_masks=masks, refresh=np.arange(8) == 5)
    ts, to = tm.step(ts, frames, s2c_masks=masks, refresh=np.arange(8) == 5)
    assert_multi_match(to, jo)


@pytest.mark.parametrize("case", ["too_few_slots", "no_card", "missing_card", "streams_split",
                                  "squares_split", "device_disagrees", "axes"])
def test_mesh_errors(case):
    """make_mesh raises for more slots than it has (naming devices=) and
    for a card that is missing (never dropping to the CPU); the pipeline
    raises where n % dp or 64 % sp is not 0 and where ``device`` disagrees
    with the mesh."""
    _, tg = _geos()
    if case == "too_few_slots":
        with pytest.raises(ValueError, match="devices="):
            make_mesh(8, devices=["cpu"] * 4)
    elif case == "no_card":
        if torch.cuda.is_available():
            pytest.skip("a card is present: make_mesh() takes it")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh(2)
    elif case == "missing_card":
        if torch.cuda.is_available():
            with pytest.raises(ValueError, match="no card"):
                make_mesh(devices=[f"cuda:{torch.cuda.device_count()}"])
        else:
            with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
                make_mesh(devices=["cuda:0"] * 2)
    elif case == "streams_split":
        with pytest.raises(ValueError, match="6 streams do not divide"):
            tms.MultiStreamPipeline(tg, 6, mesh=make_mesh(4, devices=["cpu"] * 4))
    elif case == "squares_split":
        with pytest.raises(ValueError, match="64 squares do not divide"):
            tms.MultiStreamPipeline(tg, 2, mesh=make_mesh(6, ("data", "space"), (2, 3),
                                                          devices=["cpu"] * 6))
    elif case == "device_disagrees":
        mesh = make_mesh(2, devices=["cpu"] * 2)
        with pytest.raises((ValueError, RuntimeError), match="disagrees|is_available"):
            tms.MultiStreamPipeline(tg, 2, mesh=mesh, device="cuda:0")
        assert tms.MultiStreamPipeline(tg, 2, mesh=mesh, device="cpu").device == torch.device("cpu")
    else:
        with pytest.raises(ValueError, match="mesh axes"):
            make_mesh(8, ("space", "data"), (2, 4), devices=CPU8)


MOVES = ("e2e4", "d2d4", "c2c4", "f2f4")


def _session_frames(seed):
    rng = np.random.default_rng(seed)
    boards = [chess.Board() for _ in MOVES]
    ref = _frames(rng, [occupancy_of(b) for b in boards])
    settle = [_frames(rng, [occupancy_of(b) for b in boards]) for _ in range(2)]
    for b, uci in zip(boards, MOVES):
        b.push_uci(uci)
    moved = [_frames(rng, [occupancy_of(b) for b in boards]) for _ in range(8)]
    return boards, ref, settle + moved


def _session(package, mesh_shape=(2, 2), geos=None):
    jg, tg = geos or _geos()
    if package == "jax":
        sess = JaxSession(jg, n_streams=4, hough_backend="conv",
                          mesh=jax_make_mesh(4, ("data", "space"), mesh_shape))
    else:
        sess = TorchSession(tg, n_streams=4, hough_backend="conv",
                            mesh=make_mesh(4, ("data", "space"), mesh_shape, devices=["cpu"] * 4))
    sess.MOVE_COOLDOWN, sess.STABILITY_REQUIRED = 0.0, 4
    return sess


def test_meshed_session_commits_the_jax_meshed_sessions_moves():
    """4 games on a 2 x 2 mesh in both packages: the same move on the same
    tick in every stream, the same FENs and PGNs."""
    boards, ref, ticks = _session_frames(38)
    committed, sessions = {}, {}
    for package in ("jax", "port"):
        sess = sessions[package] = _session(package)
        sess.capture_reference(ref)
        committed[package] = [[m and m.uci() for m in sess.on_frames(fr)] for fr in ticks]
    assert committed["port"] == committed["jax"]
    assert [next(t[i] for t in committed["port"] if t[i]) for i in range(4)] == list(MOVES)
    assert isinstance(sessions["port"].state, tms.MeshState)
    for i, b in enumerate(boards):
        assert (sessions["port"].streams[i].game.get_fen()
                == sessions["jax"].streams[i].game.get_fen() == b.fen())
        assert sessions["port"].to_pgn(i) == sessions["jax"].to_pgn(i)


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_meshed_checkpoint_crosses_packages(src, dst, tmp_path):
    """A meshed session saves mid-game (the port's state gathered into the
    JAX package's npz) and a meshed session of the other package resumes:
    the same state leaf for leaf, then the same commits and FENs."""
    boards, ref, ticks = _session_frames(39)
    first = _session(src)
    first.capture_reference(ref)
    before = [[m and m.uci() for m in first.on_frames(fr)] for fr in ticks[:4]]
    path = str(tmp_path / "mesh.npz")
    first.save_checkpoint(path)
    resumed = _session(dst, mesh_shape=(4, 1))
    meta = resumed.resume_checkpoint(path)
    assert meta["n"] == 4 and resumed.frame_count == first.frame_count == 4
    gathered = [tms.multistream_state_to_numpy(s.state) if isinstance(s.state, tms.MeshState)
                else jax.tree.map(np.asarray, s.state) for s in (first, resumed)]
    for a, b in zip(tckpt.tree_leaves(gathered[0]), tckpt.tree_leaves(gathered[1])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    after = [[[m and m.uci() for m in s.on_frames(fr)] for fr in ticks[4:]]
             for s in (first, resumed)]
    assert after[0] == after[1]
    assert [next(t[i] for t in before + after[1] if t[i]) for i in range(4)] == list(MOVES)
    for i, b in enumerate(boards):
        assert first.streams[i].game.get_fen() == resumed.streams[i].game.get_fen() == b.fen()


class _Bump:
    """A drift monitor stand-in: confirms ``corners`` on its ``at``-th check."""

    def __init__(self, corners, at=None):
        self.corners, self.at, self.checks = corners, at, 0
        self.threshold_px, self.max_px, self.confirm = 4.0, 80.0, 2

    def check(self, frame):
        self.checks += 1
        return self.corners if self.checks == self.at else None


def test_meshed_drift_rebuild_keeps_the_mesh():
    """Rig 1 confirmed bumped on a drift check: both packages' meshed
    sessions rebuild in per-stream-geometry mode on the same mesh, replace
    only rig 1's state, and keep committing the same moves. A 640x480 rig
    of the default margin: ``with_corners`` rebuilds a geometry with it."""
    home = ff.FLEET_CORNERS * 2
    bumped = home + SHIFT
    rng = np.random.default_rng(40)
    boards = [chess.Board() for _ in MOVES]
    corners = [home, bumped, home, home]
    size = (480, 640)

    def frames(rigs):
        return _frames(rng, [occupancy_of(b) for b in boards], rigs, frame_size=size)

    ref = frames([home] * 4)
    ticks = [frames(corners) for _ in range(3)]
    for b, uci in zip(boards, MOVES):
        b.push_uci(uci)
    ticks += [frames(corners) for _ in range(8)]
    logs, sessions = {}, {}
    for package in ("jax", "port"):
        sess = sessions[package] = _session(package, geos=_geos(home, (640, 480), 100))
        sess.drift_check_interval = 2
        sess.drift = [_Bump(c, at=2 if i == 1 else None) for i, c in enumerate(corners)]
        sess.capture_reference(ref)
        logs[package] = []
        for t, fr in enumerate(ticks):
            logs[package].append([m and m.uci() for m in sess.on_frames(fr)])
            if t == 1:  # the tick of the rebuild
                assert sess.ms._stream_plans is not None and sess.ms.mesh is not None
    port, jax_sess = sessions["port"], sessions["jax"]
    assert logs["port"] == logs["jax"]
    assert port.ms.mesh.shape == {"data": 2, "space": 2} and isinstance(port.state, tms.MeshState)
    np.testing.assert_array_equal(port.geometries[1].src_corners, bumped)
    assert [next(t[i] for t in logs["port"] if t[i]) for i in range(4)] == list(MOVES)
    assert_multi_states_match(port.state, jax_sess.state)
