"""N-stream parity: the port's device noise FSM, MultiStreamPipeline and
MultiStreamSession against the JAX package's, on the CPU.

The JAX N-stream pipeline runs on the CPU as a scan over streams of the
single-stream program; the port runs the stream-folded core (one step of
N*64 squares). Both see the same 1280x720 frames and start from the same
state. StepOutputs and NoiseFsmOut must agree: bool/i32 fields exactly, f32
fields within tests/test_torch_pipeline.py's tolerance. Most cases run the
conv Hough backend on planar frames (the matmul resample), named on both
sides; the shared-geometry HWC tick (both packages' gather warp) and the
exact-backend tick are held as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessboard_vision_tpu import geometry as jgeo
from chessboard_vision_tpu.ops import fsm as jfsm
from chessboard_vision_tpu.ops import warp as jwarp
from chessboard_vision_tpu.parallel.multistream import MultiStreamPipeline as JaxMulti
from chessboard_vision_tpu.parallel.session import MultiStreamSession as JaxSession
from chessboard_vision_tpu_torch import geometry as tgeo
from chessboard_vision_tpu_torch.models import pipeline as tp
from chessboard_vision_tpu_torch.ops import fsm as tfsm
from chessboard_vision_tpu_torch.ops import warp as twarp
from chessboard_vision_tpu_torch.ops.layout import positions_to_mask, to_planar
from chessboard_vision_tpu_torch.parallel import multistream as tms
from chessboard_vision_tpu_torch.parallel.session import MultiStreamSession as TorchSession
from chessboard_vision_tpu_torch.session.noise import NoiseHandler, NoiseState

from fixtures import DEFAULT_CORNERS, initial_occupancy, make_board_frame
from test_torch_pipeline import EXACT, F32_ATOL, F32_RTOL

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

MODE_OF = {
    NoiseState.IDLE: tfsm.MODE_IDLE,
    NoiseState.NOISE_ACTIVE: tfsm.MODE_NOISE,
    NoiseState.MOVE_PENDING: tfsm.MODE_PENDING,
}


def _change_sets(rng, streams, ticks):
    """(streams, ticks, 64) bool: per tick no change (40%), 1-3 changed
    squares (30%) or 4-9, a hand (30%), as tests/test_parallel.py draws."""
    out = np.zeros((streams, ticks, 64), bool)
    for s in range(streams):
        for t in range(ticks):
            k = rng.integers(0, 10)
            if k >= 4:
                n = int(rng.integers(1, 4) if k < 7 else rng.integers(4, 10))
                out[s, t, rng.integers(0, 64, n)] = True
    return out


def test_fsm_matches_jax_fsm_and_host_noise_handler():
    """4 x 300 random change sets through the port's FSM, the JAX FSM and
    the port's host NoiseHandler: every state field and output agree."""
    seqs = _change_sets(np.random.default_rng(3), 4, 300)
    jstep = jax.jit(jfsm.noise_step)
    for trial, seq in enumerate(seqs):
        host, dev, jdev = NoiseHandler(), tfsm.init_state(device="cpu"), jfsm.init_state()
        for t, changed in enumerate(seq):
            squares = {(int(s) % 8, int(s) // 8) for s in np.flatnonzero(changed)}
            _, h_data = host.process(squares)
            dev, out = tfsm.noise_step(dev, torch.from_numpy(changed))
            jdev, jout = jstep(jdev, jnp.asarray(changed))
            where = f"trial {trial} tick {t}"
            for a, b in ((dev, jdev), (out, jout)):
                for f in a._fields:
                    x, y = getattr(a, f).numpy(), np.asarray(getattr(b, f))
                    assert x.dtype == y.dtype and np.array_equal(x, y), f"{where} {f}"
            assert int(dev.mode) == MODE_OF[host.state], where
            assert int(dev.stable_count) == host.stable_count, where
            fired = h_data.get("stable", False) or h_data.get("message") == "move_ready"
            assert bool(out.stable) == bool(fired), where
            if fired:
                got = {(int(s) % 8, int(s) // 8) for s in np.flatnonzero(out.squares.numpy())}
                assert got == h_data["squares"], where
            lift = host.last_lifted_square
            assert int(dev.lifted) == (-1 if lift is None else lift[1] * 8 + lift[0]), where


def test_fsm_batched_equals_per_stream():
    """(N, 64) with (N,) scalars in one step equals N one-stream FSMs."""
    seqs = _change_sets(np.random.default_rng(4), 5, 200)
    batched = tfsm.init_state(5, device="cpu")
    singles = [tfsm.init_state(device="cpu") for _ in range(5)]
    assert batched.pending.shape == (5, 64) and batched.mode.shape == (5,)
    for t in range(seqs.shape[1]):
        batched, bout = tfsm.noise_step(batched, torch.from_numpy(seqs[:, t]))
        for s in range(5):
            singles[s], out = tfsm.noise_step(singles[s], torch.from_numpy(seqs[s, t]))
            for a, b in ((batched, singles[s]), (bout, out)):
                for f in a._fields:
                    assert torch.equal(getattr(a, f)[s], getattr(b, f)), f"tick {t} stream {s} {f}"


def assert_multi_match(t_out, j_out, where=""):
    """Port MultiStreamOutputs (device) vs JAX MultiStreamOutputs."""
    t_out = tms.outputs_to_numpy(t_out)
    for f in tp.StepOutputs._fields:
        t, j = getattr(t_out.step, f), np.asarray(getattr(j_out.step, f))
        assert t.dtype == j.dtype and t.shape == j.shape, f"{where} {f}"
        if f in EXACT:
            np.testing.assert_array_equal(t, j, err_msg=f"{where} {f}")
        else:
            np.testing.assert_allclose(t, j, rtol=F32_RTOL, atol=F32_ATOL, err_msg=f"{where} {f}")
    for f in tfsm.NoiseFsmOut._fields:
        t, j = getattr(t_out.noise, f), np.asarray(getattr(j_out.noise, f))
        assert t.dtype == j.dtype, f"{where} noise.{f}"
        np.testing.assert_array_equal(t, j, err_msg=f"{where} noise.{f}")


def assert_multi_states_match(t_state, j_state):
    for (path, t), j in zip(_named_leaves(tms.multistream_state_to_numpy(t_state)),
                            jax.tree.leaves(j_state)):
        j = np.asarray(j)
        assert t.dtype == j.dtype and t.shape == j.shape, path
        if t.dtype == np.float32:
            np.testing.assert_allclose(t, j, rtol=F32_RTOL, atol=F32_ATOL, err_msg=path)
        else:
            np.testing.assert_array_equal(t, j, err_msg=path)


def _named_leaves(tree, prefix=""):
    if hasattr(tree, "_fields"):
        return [leaf for f in tree._fields
                for leaf in _named_leaves(getattr(tree, f), f"{prefix}.{f}")]
    return [(prefix, tree)]


def _moved(occ, *moves):
    occ = occ.copy()
    for (ff, fr), (tf, tr) in moves:
        occ[ff, fr], occ[tf, tr] = False, True
    return occ


ALL_SQUARES = {(f, r) for f in range(8) for r in range(8)}
OCC0 = initial_occupancy()
E4 = _moved(OCC0, ((4, 1), (4, 3)))
D4 = _moved(OCC0, ((3, 1), (3, 3)))
SHIFTED = DEFAULT_CORNERS + np.array([[14, 9], [-11, 6], [8, -7], [-12, -10]])
ENHANCER_PROFILE = {"contrast": 1.1, "brightness": 4}


def _frames(rng, occs, corners=None):
    corners = corners or [DEFAULT_CORNERS] * len(occs)
    return np.stack([to_planar(make_board_frame(o, rng, corners=c))
                     for o, c in zip(occs, corners)])


@pytest.fixture(scope="module")
def shared_pipes():
    g = jgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    return (JaxMulti(g, n_streams=3, hough_backend="conv"),
            tms.MultiStreamPipeline(tgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS),
                                    n_streams=3, hough_backend="conv", device="cpu"))


def test_shared_geometry_matches_jax_with_per_stream_masks_and_refresh(shared_pipes):
    """3 streams in different positions, a hand over one of them, square
    masks and re-reference flags that differ per stream: every tick's
    outputs and the final state equal the JAX package's."""
    jm, tm = shared_pipes
    rng = np.random.default_rng(21)
    ref = _frames(rng, [OCC0] * 3)
    js = jm.capture_reference(jm.init_state(), ref)
    ts = tm.capture_reference(tm.init_state(), ref)
    assert_multi_states_match(ts, js)
    masks = np.stack([positions_to_mask({(4, 1), (4, 3)}), np.ones(64, bool),
                      positions_to_mask({(0, 0), (3, 3)})])
    ticks = [
        (OCC0, E4, D4), (OCC0, E4, D4), (E4, E4, D4), (OCC0, E4, D4), (E4, D4, D4),
    ]
    controls = [
        (None, None), (masks, [True, False, True]), (None, [False, True, False]),
        (masks, None), (masks, [False, False, True]),
    ]
    for t, (occs, (m, r)) in enumerate(zip(ticks, controls)):
        frames = _frames(rng, occs)
        if t == 3:
            frames[1][:, 250:520, 450:800] = np.array([100, 110, 120], np.uint8)[:, None, None]
        js, jo = jm.step(js, frames, s2c_masks=m, refresh=r)
        ts, to = tm.step(ts, frames, s2c_masks=m, refresh=r)
        assert_multi_match(to, jo, where=f"tick {t}")
    assert_multi_states_match(ts, js)
    assert tp.occupancy_to_set(to.step.raw_occupancy[1]) == {
        (f, r) for f in range(8) for r in range(8) if D4[f, r]
    }


def test_per_stream_geometry_matches_jax():
    """Three rigs with different corners (HWC frames to the port), square
    masks and re-reference flags that differ per stream: every tick's
    outputs equal the JAX package's per-stream-geometry pipeline and show
    each rig's position."""
    corners = [DEFAULT_CORNERS, SHIFTED,
               DEFAULT_CORNERS + np.array([[-9, 12], [7, -8], [-6, 5], [10, 11]])]
    jm = JaxMulti([jgeo.BoardGeometry.from_calibration(c) for c in corners], n_streams=3,
                  hough_backend="conv")
    tm = tms.MultiStreamPipeline([tgeo.BoardGeometry.from_calibration(c) for c in corners],
                                 n_streams=3, hough_backend="conv", device="cpu")
    rng = np.random.default_rng(22)
    ref = _frames(rng, [OCC0] * 3, corners)
    js = jm.capture_reference(jm.init_state(), ref)
    ts = tm.capture_reference(tm.init_state(), np.moveaxis(ref, 1, -1))  # HWC
    masks = np.stack([np.ones(64, bool), positions_to_mask({(4, 1), (4, 3)}),
                      positions_to_mask({(3, 1), (3, 3)})])
    for t, (occs, r) in enumerate([((OCC0, E4, D4), None), ((D4, E4, D4), [False, True, False])]):
        frames = _frames(rng, occs, corners)
        js, jo = jm.step(js, frames, s2c_masks=masks, refresh=r)
        ts, to = tm.step(ts, np.moveaxis(frames, 1, -1), s2c_masks=masks, refresh=r)
        assert_multi_match(to, jo, where=f"tick {t}")
    for i, occ in enumerate((D4, E4, D4)):
        assert tp.occupancy_to_set(to.step.raw_occupancy[i]) == {
            (f, r) for f in range(8) for r in range(8) if occ[f, r]
        }


def test_step_chunk_matches_jax_and_sequential_ticks(shared_pipes):
    """step_chunk over T=3 ticks equals the JAX package's step_chunk and,
    exactly, 3 sequential step calls; outputs are (T, N, ...)."""
    jm, tm = shared_pipes
    rng = np.random.default_rng(23)
    ref = _frames(rng, [OCC0] * 3)
    chunk = np.stack([_frames(rng, occs) for occs in
                      [(OCC0, E4, D4), (E4, E4, D4), (E4, OCC0, D4)]])
    js = jm.capture_reference(jm.init_state(), ref)
    ts = tm.capture_reference(tm.init_state(), ref)
    seq = tms.multistream_state_from_numpy(tms.multistream_state_to_numpy(ts), device="cpu")
    js, jo = jm.step_chunk(js, chunk)
    ts, to = tm.step_chunk(ts, chunk)
    assert to.step.occupancy.shape == (3, 3, 64) and to.noise.mode.shape == (3, 3)
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
    for a, b in zip(_named_leaves(tms.multistream_state_to_numpy(seq)),
                    _named_leaves(tms.multistream_state_to_numpy(ts))):
        np.testing.assert_array_equal(a[1], b[1], err_msg=a[0])


def test_state_from_numpy_starts_both_packages_from_one_state(shared_pipes):
    """A JAX mid-sequence state converted with multistream_state_from_numpy
    steps to the same outputs in both packages; the round trip is lossless."""
    jm, tm = shared_pipes
    rng = np.random.default_rng(24)
    js = jm.capture_reference(jm.init_state(), _frames(rng, [OCC0] * 3))
    js, _ = jm.step(js, _frames(rng, [E4, OCC0, D4]))
    host = jax.tree.map(np.asarray, js)
    ts = tms.multistream_state_from_numpy(host, device="cpu")
    for (path, a), b in zip(_named_leaves(tms.multistream_state_to_numpy(ts)),
                            jax.tree.leaves(host)):
        np.testing.assert_array_equal(a, b, err_msg=path)
    frames = _frames(rng, [E4, OCC0, D4])
    js, jo = jm.step(js, frames, refresh=[False, True, False])
    ts, to = tm.step(ts, frames, refresh=[False, True, False])
    assert_multi_match(to, jo)


def _assert_streams_equal_single_pipelines(host, singles, ref, frames, refresh):
    """Each stream's host outputs of one tick (every square checked) equal
    its own single-stream pipeline's after the same capture and step."""
    for i, single in enumerate(singles):
        st = single.capture_reference(single.init_state(), ref[i])
        st, o = single.step(st, frames[i], squares_to_check=ALL_SQUARES,
                            refresh_refs=bool(refresh[i]))
        o = tp.outputs_to_numpy(o)
        for f in tp.StepOutputs._fields:
            np.testing.assert_array_equal(getattr(host.step, f)[i], getattr(o, f),
                                          err_msg=f"stream {i} {f}")


def test_enhanced_streams_match_single_stream_enhanced_pipelines():
    """with_enhancer=True, 2 streams in different positions: each stream's
    outputs equal the port's single-stream enhanced pipeline (held against
    the JAX package with its TPU kernels in tests/test_torch_pipeline.py)."""
    g = tgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    tm = tms.MultiStreamPipeline(g, n_streams=2, with_enhancer=True, hough_backend="conv",
                                 enhancer_profile=ENHANCER_PROFILE, device="cpu")
    single = tp.VisionPipeline(g, with_enhancer=True, enhancer_profile=ENHANCER_PROFILE,
                               hough_backend="conv", device="cpu")
    rng = np.random.default_rng(25)
    ref = _frames(rng, [OCC0, OCC0])
    frames = _frames(rng, [OCC0, E4])
    refresh = [True, False]
    ts = tm.capture_reference(tm.init_state(), ref)
    ts, to = tm.step(ts, frames, s2c_masks=np.ones((2, 64), bool), refresh=refresh)
    host = tms.outputs_to_numpy(to)
    _assert_streams_equal_single_pipelines(host, [single, single], ref, frames, refresh)
    assert tp.occupancy_to_set(host.step.raw_occupancy[1]) == {
        (f, r) for f in range(8) for r in range(8) if E4[f, r]
    }


def test_enhanced_per_stream_geometry_matches_single_stream_enhanced_pipelines():
    """with_enhancer=True and 2 rigs, the second's corners shifted: each
    stream's board is warped with its own rig's tile plan, so its outputs
    equal the single-stream enhanced pipeline of that rig."""
    corners = [DEFAULT_CORNERS, SHIFTED]
    geos = [tgeo.BoardGeometry.from_calibration(c) for c in corners]
    tm = tms.MultiStreamPipeline(geos, n_streams=2, with_enhancer=True, hough_backend="conv",
                                 enhancer_profile=ENHANCER_PROFILE, device="cpu")
    singles = [tp.VisionPipeline(g, with_enhancer=True, enhancer_profile=ENHANCER_PROFILE,
                                 hough_backend="conv", device="cpu") for g in geos]
    rng = np.random.default_rng(28)
    ref = _frames(rng, [OCC0, OCC0], corners)
    frames = _frames(rng, [E4, D4], corners)
    refresh = [False, True]
    ts = tm.capture_reference(tm.init_state(), ref)
    ts, to = tm.step(ts, frames, s2c_masks=np.ones((2, 64), bool), refresh=refresh)
    host = tms.outputs_to_numpy(to)
    _assert_streams_equal_single_pipelines(host, singles, ref, frames, refresh)
    for i, occ in enumerate((E4, D4)):
        assert tp.occupancy_to_set(host.step.raw_occupancy[i]) == {
            (f, r) for f in range(8) for r in range(8) if occ[f, r]
        }


MOVES = ("e2e4", "d2d4", "g1f3", "c2c4")


def test_session_commits_the_same_moves_and_fens_as_jax():
    """4 games, each playing a different first move, through the JAX and
    the port's MultiStreamSession on the same frames: the same move on the
    same tick in every stream, the same FENs and PGNs."""
    from chessboard_vision_tpu_torch.rules import chess
    from chessboard_vision_tpu_torch.tools.demo_pipeline import occupancy_of

    rng = np.random.default_rng(26)
    boards = [chess.Board() for _ in MOVES]
    ref = _frames(rng, [occupancy_of(b) for b in boards])
    settle = [_frames(rng, [occupancy_of(b) for b in boards]) for _ in range(2)]
    for b, uci in zip(boards, MOVES):
        b.push_uci(uci)
    moved = [_frames(rng, [occupancy_of(b) for b in boards]) for _ in range(8)]

    g = jgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    jsess = JaxSession(g, n_streams=4, hough_backend="conv")
    tsess = TorchSession(tgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS), n_streams=4,
                         hough_backend="conv", device="cpu")
    committed = {}
    for name, sess in (("jax", jsess), ("port", tsess)):
        sess.MOVE_COOLDOWN = 0.0
        sess.STABILITY_REQUIRED = 6
        sess.capture_reference(ref)
        ticks = [[m and m.uci() for m in sess.on_frames(fr)] for fr in settle + moved]
        committed[name] = ticks
    assert committed["port"] == committed["jax"]
    firsts = [next(t[i] for t in committed["port"] if t[i]) for i in range(4)]
    assert firsts == list(MOVES)
    for i, b in enumerate(boards):
        assert tsess.streams[i].game.get_fen() == jsess.streams[i].game.get_fen() == b.fen()
        assert tsess.to_pgn(i) == jsess.to_pgn(i)


def _hwc_tick_inputs(seed):
    rng = np.random.default_rng(seed)
    ref = np.moveaxis(_frames(rng, [OCC0] * 3), 1, -1)
    frames = np.moveaxis(_frames(rng, [OCC0, E4, D4]), 1, -1)
    masks = np.stack([positions_to_mask({(4, 1), (4, 3)}), np.ones(64, bool),
                      positions_to_mask({(3, 1), (3, 3)})])
    return ref, frames, masks


def test_shared_geometry_hwc_tick_matches_jax_gather_warp():
    """3 streams of HWC camera frames under one geometry: both packages
    warp them by gather (the JAX package keeps host HWC frames HWC in this
    mode), so the squares are bit-equal to the JAX warp's and every
    output equals the JAX tick's."""
    g = jgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    tg = tgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    jm = JaxMulti(g, n_streams=3, hough_backend="conv")
    tm = tms.MultiStreamPipeline(tg, n_streams=3, hough_backend="conv", device="cpu")
    ref, frames, masks = _hwc_tick_inputs(27)
    want = np.asarray(jax.jit(jax.vmap(jwarp.frame_to_squares, in_axes=(0, None)))(
        jnp.asarray(frames), jwarp.DeviceGeometry.from_host(g)))
    got = twarp.frame_to_squares(torch.from_numpy(frames), tm.pipe.consts.dg)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    js = jm.capture_reference(jm.init_state(), ref)
    ts = tm.capture_reference(tm.init_state(), ref)
    assert_multi_states_match(ts, js)
    js, jo = jm.step(js, frames, s2c_masks=masks, refresh=[False, True, False])
    ts, to = tm.step(ts, frames, s2c_masks=masks, refresh=[False, True, False])
    assert_multi_match(to, jo, where="HWC tick")
    assert_multi_states_match(ts, js)


def test_exact_backend_tick_matches_jax():
    """hough_backend="exact" (the port's auto on the CPU): the folded core
    tiles the Hough params to 3*64 squares; a 3-stream HWC tick equals the
    JAX exact tick, and each stream shows its position."""
    g = jgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    jm = JaxMulti(g, n_streams=3, hough_backend="exact")
    tm = tms.MultiStreamPipeline(tgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS),
                                 n_streams=3, device="cpu")
    assert tm.pipe.hough_backend == "exact" and tm.consts.conv_plan is None
    assert tm.consts.params.max_radius.shape == (3 * 64,)
    ref, frames, masks = _hwc_tick_inputs(29)
    js = jm.capture_reference(jm.init_state(), ref)
    ts = tm.capture_reference(tm.init_state(), ref)
    js, jo = jm.step(js, frames, s2c_masks=np.ones((3, 64), bool))
    ts, to = tm.step(ts, frames, s2c_masks=np.ones((3, 64), bool))
    assert_multi_match(to, jo, where="exact tick")
    for i, occ in enumerate((OCC0, E4, D4)):
        assert tp.occupancy_to_set(to.step.raw_occupancy[i]) == {
            (f, r) for f in range(8) for r in range(8) if occ[f, r]
        }


def test_session_surface():
    g = tgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    with pytest.raises(NotImplementedError, match="A17"):
        TorchSession(g, n_streams=2, auto_recalibrate=True, device="cpu")
    with pytest.raises(ValueError, match="grid structure"):
        bad = tgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS // 2, display_size=(640, 360))
        tms.MultiStreamPipeline([g, bad], n_streams=2, device="cpu")
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tms.MultiStreamPipeline(g, n_streams=2)
