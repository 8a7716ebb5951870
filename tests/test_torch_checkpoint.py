"""Checkpoints cross between the packages: a JAX GameSession or
MultiStreamSession checkpoint resumes in the port's, and the reverse.

Both packages write the same npz (leaves in NamedTuple field order, JSON
meta). A session plays a scripted move, saves mid-game, and a fresh session
of the OTHER package resumes from the file: the resumed state equals the
saved one leaf for leaf, the next frame's StepOutputs agree with the
original session's (bool/i32 exactly, f32 within
tests/test_torch_pipeline.py's tolerance), and both commit the next move
on the same frame with the same FEN. Both packages' sessions run the conv
Hough backend (the JAX ones forced to it, the port's naming it), so a
checkpoint carries the same detector across. ``load_tree``'s two
legacy-leaf rules are held to the JAX package's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessboard_vision_tpu import geometry as jgeo
from chessboard_vision_tpu.models.pipeline import VisionPipeline as JaxPipeline
from chessboard_vision_tpu.parallel.session import MultiStreamSession as JaxMultiSession
from chessboard_vision_tpu.session import game_session as jax_session_mod
from chessboard_vision_tpu.utils import checkpoint as jckpt
from chessboard_vision_tpu_torch import geometry as tgeo
from chessboard_vision_tpu_torch.models import pipeline as tp
from chessboard_vision_tpu_torch.ops import change as tchange
from chessboard_vision_tpu_torch.ops.layout import to_planar
from chessboard_vision_tpu_torch.parallel.session import MultiStreamSession as TorchMultiSession
from chessboard_vision_tpu_torch.rules import chess
from chessboard_vision_tpu_torch.session.game_session import GameSession as TorchSession
from chessboard_vision_tpu_torch.tools.demo_pipeline import occupancy_of
from chessboard_vision_tpu_torch.utils import checkpoint as tckpt

from fixtures import DEFAULT_CORNERS, make_board_frame
from test_torch_pipeline import assert_outputs_match

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

CONFIG = {
    "corners": DEFAULT_CORNERS.tolist(),
    "player_color": "white",
    "orientation_flipped": False,
    "grid_lines_x": None,
    "grid_lines_y": None,
}
STABILITY = 6  # frames to commit a move (the sessions' 20, cut for test time)


def _host_leaves(tree):
    """Leaves of either package's state as numpy, in field order."""
    return [x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in tckpt.tree_leaves(tree)]


def _assert_leaves_equal(a, b):
    for i, (x, y) in enumerate(zip(_host_leaves(a), _host_leaves(b))):
        assert x.dtype == y.dtype, i
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")
    assert len(_host_leaves(a)) == len(_host_leaves(b))


def _drive(session, frames):
    """Feed frames until a move commits: (move uci, frame index) or None."""
    for i, fr in enumerate(frames):
        move = session.on_frame(fr)
        if move:
            return move.uci(), i
    return None


def _new_session(package):
    if package == "jax":
        return jax_session_mod.GameSession(headless=True)
    return TorchSession(device="cpu", hough_backend="conv")


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_game_session_checkpoint_resumes_in_the_other_package(src, dst, tmp_path, monkeypatch):
    monkeypatch.setattr(
        jax_session_mod, "VisionPipeline", functools.partial(JaxPipeline, hough_backend="conv")
    )
    rng = np.random.default_rng(31)
    script = chess.Board()
    frame0 = make_board_frame(occupancy_of(script), rng)
    script.push_uci("e2e4")
    e4 = [make_board_frame(occupancy_of(script), rng) for _ in range(12)]
    script.push_uci("e7e5")
    e5 = [make_board_frame(occupancy_of(script), rng) for _ in range(12)]

    first = _new_session(src)
    if src == "jax":
        assert first.on_calibration_requested(None, config=dict(CONFIG))
    else:
        assert first.on_calibration_requested(config=dict(CONFIG))
    first.MOVE_COOLDOWN, first.STABILITY_REQUIRED = 0.0, STABILITY
    first.capture_reference_frame(frame0)
    assert _drive(first, e4)[0] == "e2e4"
    for fr in e5[:2]:  # mid-move: the noise FSM holds the new changes
        assert first.on_frame(fr) is None
    path = str(tmp_path / "game.npz")
    first.save_checkpoint(path)

    resumed = _new_session(dst)
    meta = resumed.resume_checkpoint(path)  # unconfigured: built from the stored config
    resumed.MOVE_COOLDOWN, resumed.STABILITY_REQUIRED = 0.0, STABILITY
    assert meta["fen"] == first.game.get_fen() == resumed.game.get_fen()
    assert resumed.frame_count == first.frame_count
    assert resumed.noise.state.name == first.noise.state.name
    assert resumed.noise.pending_squares == first.noise.pending_squares
    _assert_leaves_equal(resumed.pipe_state, first.pipe_state)

    # The next frame's outputs from both sessions' states (copies: the JAX
    # step donates its state).
    port_sess, jax_sess = (resumed, first) if dst == "port" else (first, resumed)
    s2c = port_sess._smart_scan_set()
    _, to = port_sess.pipeline.step(port_sess.pipe_state, e5[2], squares_to_check=s2c)
    _, jo = jax_sess.pipeline.step(jax.tree.map(jnp.array, jax_sess.pipe_state),
                                   e5[2], squares_to_check=s2c)
    assert_outputs_match(to, jo, where="after resume")

    got_first, got_resumed = _drive(first, e5[2:]), _drive(resumed, e5[2:])
    assert got_first is not None and got_first == got_resumed and got_first[0] == "e7e5"
    assert first.game.get_fen() == resumed.game.get_fen() == script.fen()


def _ms_frames(rng, occs):
    return np.stack([to_planar(make_board_frame(o, rng)) for o in occs])


def _new_multi(package, n=2):
    if package == "jax":
        sess = JaxMultiSession(jgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS),
                               n_streams=n, hough_backend="conv")
    else:
        sess = TorchMultiSession(tgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS),
                                 n_streams=n, hough_backend="conv", device="cpu")
    sess.MOVE_COOLDOWN, sess.STABILITY_REQUIRED = 0.0, 4
    return sess


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_multistream_checkpoint_resumes_in_the_other_package(src, dst, tmp_path):
    """Two games (stream 0 plays e2e4, then black's e7e5; stream 1 waits,
    then plays e2e4): save after the first move, resume in a fresh session
    of the other package, and both sessions make the same decisions on
    every later tick and end on the same FENs."""
    rng = np.random.default_rng(32)
    b0, b1 = chess.Board(), chess.Board()
    ref = _ms_frames(rng, [occupancy_of(b0), occupancy_of(b1)])
    b0.push_uci("e2e4")
    phase1 = [_ms_frames(rng, [occupancy_of(b0), occupancy_of(b1)]) for _ in range(6)]
    b0.push_uci("e7e5")
    b1.push_uci("e2e4")
    phase2 = [_ms_frames(rng, [occupancy_of(b0), occupancy_of(b1)]) for _ in range(7)]

    first = _new_multi(src)
    first.capture_reference(ref)
    ticks1 = [[m and m.uci() for m in first.on_frames(fr)] for fr in phase1]
    assert ["e2e4", None] in ticks1, ticks1
    path = str(tmp_path / "multi.npz")
    first.save_checkpoint(path)

    resumed = _new_multi(dst)
    meta = resumed.resume_checkpoint(path)
    assert meta["n"] == 2 and resumed.frame_count == first.frame_count
    _assert_leaves_equal(resumed.state, first.state)

    ticks_first = [[m and m.uci() for m in first.on_frames(fr)] for fr in phase2]
    ticks_resumed = [[m and m.uci() for m in resumed.on_frames(fr)] for fr in phase2]
    assert ticks_first == ticks_resumed
    assert ["e7e5", "e2e4"] == [next(t[i] for t in ticks_first if t[i]) for i in range(2)]
    for i, b in enumerate((b0, b1)):
        assert first.streams[i].game.get_fen() == resumed.streams[i].game.get_fen() == b.fen()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_multistream_checkpoint_rejects_another_stream_count(package, tmp_path):
    """A 2-stream checkpoint of either package does not resume into the
    port's 4-stream session."""
    sess = _new_multi(package)
    sess.capture_reference(_ms_frames(np.random.default_rng(33), [occupancy_of(chess.Board())] * 2))
    path = str(tmp_path / "two.npz")
    sess.save_checkpoint(path)
    with pytest.raises(ValueError, match="2 streams"):
        _new_multi("port", n=4).resume_checkpoint(path)


def _legacy_cases():
    """(saved leaves as the JAX package wrote them, the template they load
    into, the leaf values the port must load)."""
    means = np.random.default_rng(0).uniform(0, 255, (64, 7, 5)).astype(np.float32)
    flat = tchange.ChangeModelState(
        torch.zeros((64, 35)), torch.zeros((64, 35)), torch.zeros(64, dtype=torch.bool))
    return {
        # ChangeModelState.calibrated was a () flag, now (64,)
        "scalar_bool_flag": (
            (jnp.zeros((64, 35)), jnp.ones((64, 35)), jnp.asarray(True)), flat,
            (np.zeros((64, 35), np.float32), np.ones((64, 35), np.float32), np.ones(64, bool))),
        # the change model's (64, H, W) means and variances, now (64, H*W)
        "3d_change_leaf": (
            (jnp.asarray(means), jnp.asarray(means + 1), jnp.ones(64, bool)), flat,
            (means.reshape(64, 35), means.reshape(64, 35) + 1, np.ones(64, bool))),
    }


@pytest.mark.parametrize("case", ["scalar_bool_flag", "3d_change_leaf"])
def test_load_tree_legacy_leaf_rules_match_jax(case, tmp_path):
    saved, template, want = _legacy_cases()[case]
    path = str(tmp_path / "legacy.npz")
    jckpt.save_tree(path, saved, {"k": 1})
    tree, meta = tckpt.load_tree(path, template, device="cpu")
    jtree, _ = jckpt.load_tree(path, jax.tree.map(lambda t: jnp.asarray(t.numpy()), template))
    assert meta == {"k": 1} and type(tree) is tchange.ChangeModelState
    for got, jgot, w in zip(tree, jax.tree.leaves(jtree), want):
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), w)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


def test_load_tree_rejects_a_leaf_of_another_shape(tmp_path):
    path = str(tmp_path / "bad.npz")
    tckpt.save_tree(path, (torch.zeros(4), torch.zeros(3)), {})
    with pytest.raises(ValueError, match="leaf 1 shape"):
        tckpt.load_tree(path, (torch.zeros(4), torch.zeros(5)), device="cpu")
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tckpt.load_tree(path, (torch.zeros(4), torch.zeros(3)))
    state = tp.VisionPipeline(tgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS),
                              device="cpu").init_state()
    assert len(tckpt.tree_leaves(state)) == 14
