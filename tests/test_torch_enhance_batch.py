"""The enhancement with a board axis: B2-B4's plain versions, the enhancer
and the N-stream tick on (N, 3, B, B) boards, on the CPU.

The JAX meshed tick vmaps its preprocessing, enhancer and three Pallas
kernels included, over a slot's boards; the port runs the enhancer's torch
chain on the stacked boards and launches each of B2-B4 once for all of
them. Here the batched plain versions must equal a stack of per-board calls
bit for bit; the batched ``enhance_planar`` must equal ``jax.vmap`` of the
JAX ``enhance_planar`` (its XLA bilateral, its CLAHE Pallas kernels in
interpret mode) and per-board JAX calls with all its Pallas kernels in
interpret mode, within ROADMAP Queue C 7's limits
(tests/test_torch_enhance.py's); and an enhanced tick of 3 streams must
reach each of the bilateral and the two CLAHE phases once, with the 3
boards, and give the JAX MultiStreamPipeline's bool/i32 outputs. Boards
are small (3 x 96 x 96, tiles of 12) and made from a numpy seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chessboard_vision_tpu import geometry as jgeo
from chessboard_vision_tpu.models import enhancer as jenh_model
from chessboard_vision_tpu.ops import enhance as jenh
from chessboard_vision_tpu.ops import filters as jfilters
from chessboard_vision_tpu.parallel.multistream import MultiStreamPipeline as JaxMulti
from chessboard_vision_tpu_torch import geometry as tgeo
from chessboard_vision_tpu_torch.kernels import bilateral as tbil
from chessboard_vision_tpu_torch.kernels import clahe as tclahe
from chessboard_vision_tpu_torch.models import enhancer as tenh_model
from chessboard_vision_tpu_torch.ops import enhance as tenh
from chessboard_vision_tpu_torch.ops import filters as tfilters
from chessboard_vision_tpu_torch.ops import fsm as tfsm
from chessboard_vision_tpu_torch.parallel import multistream as tms
from chessboard_vision_tpu_torch.tools.synth import initial_occupancy, render_board

import fleet_fixture as ff
from fixtures import make_board_frame
from test_torch_enhance import ENHANCE_FRACTION, ENHANCE_MAX_DIFF, PROFILE
from test_torch_pipeline import EXACT

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

PX, TILES = 96, 8
TH = TW = PX // TILES
CLIP = max(int(3.0 * TH * TW / 256), 1)
BOARDS = [1, 3]


def _boards(n, seed=0):
    """(n, 3, PX, PX) u8: rendered noisy top-down boards, each its own render."""
    rng = np.random.default_rng(seed)
    out = [np.moveaxis(np.clip(np.round(render_board(initial_occupancy(), PX, rng)), 0, 255),
                       -1, 0) for _ in range(n)]
    return np.ascontiguousarray(np.stack(out)).astype(np.uint8)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _stack(fn, xs, *args):
    """fn on each board of xs, stacked (every output of a tuple apart)."""
    outs = [fn(x, *args) for x in xs]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


@pytest.mark.parametrize("n", BOARDS)
def test_bilateral_batch_equals_per_board(n):
    """B2's plain version and its wrapper on a CPU tensor: (n, 3, H, W)
    equals n single-board calls bit for bit; a 3-D board is one board."""
    x = _t(_boards(n, seed=n))
    got = tbil.bilateral_reference(x)
    assert got.shape == x.shape and got.dtype == torch.uint8
    assert torch.equal(got, _stack(tbil.bilateral_reference, x))
    assert torch.equal(tbil.bilateral_planar(x), got)
    assert torch.equal(tenh_model.bilateral(x), got)
    assert torch.equal(tbil.bilateral_planar(x[0]), got[0])


@pytest.mark.parametrize("n", BOARDS)
def test_clahe_kernels_batch_equal_per_board(n):
    """B3 (histograms + LUTs, histograms alone) and B4's plain versions on
    (n, H, W) planes, with (n, tiles^2, 256) histograms and LUTs: each equal
    to n single-board calls bit for bit, and so is ops.enhance.clahe. The
    odd-sized planes cut into tiles with a reflect pad."""
    rng = np.random.default_rng(10 + n)
    for shape in ((PX, PX), (91, 85)):
        img = _t(rng.integers(0, 256, (n,) + shape, np.uint8))
        th, tw = -(-shape[0] // TILES), -(-shape[1] // TILES)
        hist, luts = tclahe.clahe_hist_luts(img, th, tw, TILES, CLIP)
        assert hist.shape == luts.shape == (n, TILES * TILES, 256)
        want = _stack(tclahe.clahe_hist_luts, img, th, tw, TILES, CLIP)
        assert torch.equal(hist, want[0]) and torch.equal(luts, want[1])
        assert torch.equal(tclahe.clahe_hist(img, th, tw, TILES), hist)
        assert torch.equal(tclahe.clahe_luts_from_hist(hist, th * tw, CLIP), luts)
        out = tclahe.clahe_apply(img, luts, th, tw, TILES)
        assert out.shape == img.shape
        assert torch.equal(out, torch.stack([tclahe.clahe_apply(b, lut, th, tw, TILES)
                                             for b, lut in zip(img, luts)]))
        assert torch.equal(tenh.clahe(img), out)
        assert torch.equal(tenh.clahe(img), _stack(tenh.clahe, img))


def test_clahe_takes_any_leading_axes_and_checks_the_luts():
    """Two leading axes equal the flattened batch; LUTs of another batch
    shape than the planes raise, naming both."""
    img = _t(np.random.default_rng(3).integers(0, 256, (2, 2, PX, PX), np.uint8))
    flat = img.reshape(4, PX, PX)
    hist, luts = tclahe.clahe_hist_luts(img, TH, TW, TILES, CLIP)
    assert hist.shape == (2, 2, TILES * TILES, 256)
    want = tclahe.clahe_hist_luts(flat, TH, TW, TILES, CLIP)
    assert torch.equal(hist.reshape(want[0].shape), want[0])
    out = tclahe.clahe_apply(img, luts, TH, TW, TILES)
    assert torch.equal(out.reshape(flat.shape),
                       tclahe.clahe_apply(flat, luts.reshape(want[1].shape), TH, TW, TILES))
    with pytest.raises(ValueError, match="luts must be"):
        tclahe.clahe_apply(flat, luts[0], TH, TW, TILES)


def test_normalize_minmax_normalizes_each_board_on_its_own():
    """A constant board beside a contrasted one: the constant board gives
    all zeros, the contrasted one its own full range, each as its
    single-board call and as the JAX function under vmap."""
    rng = np.random.default_rng(4)
    contrasted = rng.integers(60, 180, (3, PX, PX), np.uint8)
    x = np.stack([np.full((3, PX, PX), 77, np.uint8), contrasted])
    got = tfilters.normalize_minmax(_t(x))
    assert int(got[0].max()) == 0
    assert int(got[1].min()) == 0 and int(got[1].max()) == 255
    assert torch.equal(got, _stack(tfilters.normalize_minmax, _t(x)))
    want = np.asarray(jax.jit(jax.vmap(jfilters.normalize_minmax))(x))
    np.testing.assert_array_equal(got.numpy(), want)


def _within_queue_c7(got, want, what):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= ENHANCE_MAX_DIFF and (d > 0).mean() <= ENHANCE_FRACTION, (
        what, d.max(), (d > 0).mean())


@pytest.mark.parametrize("profile", [None, PROFILE], ids=["no_profile", "profile"])
@pytest.mark.parametrize("n", BOARDS)
def test_enhance_planar_batch_vs_jax_vmap(monkeypatch, n, profile):
    """The batched enhance_planar vs jax.vmap of the JAX enhance_planar with
    bilateral_backend="xla", within Queue C 7's limits, and bit-equal to n
    single-board calls of the port.

    The JAX side's CLAHE runs its Pallas kernels in interpret mode under the
    vmap, as the meshed tick runs them on a TPU (its bilateral's Pallas
    kernel cannot: vmap of the interpreted kernel reads out of bounds).
    Its "auto" CLAHE, the XLA stand-ins, is within one level of those
    kernels on 0.26-0.54% of these rendered boards' pixels, which the
    bilateral and the sharpen spread to up to 10 levels on ~1.9% of the
    pixels (ROADMAP Queue C 7): a gap between the JAX package's own two
    forms, which the port, equal to the kernels, inherits against XLA."""
    monkeypatch.setattr(jenh, "clahe", functools.partial(jenh.clahe, backend="pallas"))
    boards = _boards(n, seed=20 + n)
    got = tenh_model.enhance_planar(_t(boards), profile)
    assert got.shape == boards.shape
    assert torch.equal(got, _stack(tenh_model.enhance_planar, _t(boards), profile))
    fn = jax.jit(jax.vmap(functools.partial(jenh_model.enhance_planar, profile=profile,
                                            bilateral_backend="xla")))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(jnp.asarray(boards)))
    _within_queue_c7(got.numpy(), want, f"vmap n={n}")


def test_enhance_planar_batch_vs_jax_pallas_per_board(monkeypatch):
    """The batched enhance_planar of 3 boards vs the JAX enhance_planar with
    its TPU kernels in interpret mode (the bilateral Pallas kernel and
    clahe(backend="pallas")), one board a call, within Queue C 7's limits."""
    monkeypatch.setattr(jenh, "clahe", functools.partial(jenh.clahe, backend="pallas"))
    boards = _boards(3, seed=30)
    got = tenh_model.enhance_planar(_t(boards), PROFILE).numpy()
    fn = jax.jit(functools.partial(jenh_model.enhance_planar, profile=PROFILE,
                                   bilateral_backend="pallas"))
    with pltpu.force_tpu_interpret_mode():
        for i, board in enumerate(boards):
            _within_queue_c7(got[i], np.asarray(fn(board)), f"board {i}")


SHIFT = np.array([[3, 2]] * 4)  # each further rig's camera moved by (3, 2) px
ENHANCER_PROFILE = {"contrast": 1.1, "brightness": 4}


def _rig_corners(n, per_stream):
    return [ff.FLEET_CORNERS + (SHIFT * s if per_stream else 0) for s in range(n)]


def _frames(seed, occs, corners):
    rng = np.random.default_rng(seed)
    return np.stack([np.moveaxis(make_board_frame(o, rng, corners=c, frame_size=ff.FRAME_SIZE),
                                 -1, 0) for o, c in zip(occs, corners)])


def _geometries(mod, corners, per_stream):
    geos = [mod.BoardGeometry.from_calibration(c, display_size=ff.DISPLAY_SIZE,
                                               margin=ff.MARGIN) for c in corners]
    return geos if per_stream else geos[0]


@pytest.mark.parametrize("per_stream", [False, True], ids=["shared_geometry", "per_stream_plans"])
def test_enhanced_tick_enhances_all_streams_at_once(monkeypatch, per_stream):
    """An enhanced MultiStreamPipeline of 3 streams, shared geometry and
    per-stream plans: the capture and the tick each call the bilateral and
    both CLAHE phases once, with the 3 boards on a leading axis (on a card:
    one launch of each of B2-B4); the tick's bool/i32 outputs equal the JAX
    MultiStreamPipeline's with its Pallas kernels in interpret mode (its
    unmeshed tick runs one stream at a time, which the interpreter takes).
    The JAX CPU stand-ins (XLA CLAHE) flip a square of these frames: see
    test_enhance_planar_batch_vs_jax_vmap."""
    n = 3
    calls = {}
    for name in ("bilateral_reference", "clahe_hist_luts_reference", "clahe_apply_reference"):
        def record(*args, _fn=getattr(tenh, name), _name=name, **kwargs):
            calls.setdefault(_name, []).append(tuple(args[0].shape))
            return _fn(*args, **kwargs)

        monkeypatch.setattr(tenh, name, record)
    corners = _rig_corners(n, per_stream)
    occs = [initial_occupancy() for _ in range(n)]
    ref = _frames(40, occs, corners)
    for s, occ in enumerate(occs):
        occ[s, 1], occ[s, 3] = False, True
    frames = _frames(41, occs, corners)
    masks = np.ones((n, 64), bool)
    kw = dict(with_enhancer=True, enhancer_profile=ENHANCER_PROFILE, hough_backend="conv")
    tm = tms.MultiStreamPipeline(_geometries(tgeo, corners, per_stream), n, device="cpu", **kw)
    B = tm.pipe.geometry.board_size
    want = {"bilateral_reference": [(n, 3, B, B)], "clahe_hist_luts_reference": [(n, B, B)],
            "clahe_apply_reference": [(n, B, B)]}
    ts = tm.capture_reference(tm.init_state(), ref)
    assert calls == want, "capture"
    calls.clear()
    ts, to = tm.step(ts, frames, s2c_masks=masks, refresh=[False, True, False])
    assert calls == want, "tick"
    monkeypatch.setattr(jenh, "clahe", functools.partial(jenh.clahe, backend="pallas"))
    with pltpu.force_tpu_interpret_mode():
        jm = JaxMulti(_geometries(jgeo, corners, per_stream), n_streams=n,
                      bilateral_backend="pallas", **kw)
        js, jo = jm.step(jm.capture_reference(jm.init_state(), ref), frames, s2c_masks=masks,
                         refresh=[False, True, False])
    host = tms.outputs_to_numpy(to)
    for f in EXACT:
        np.testing.assert_array_equal(getattr(host.step, f), np.asarray(getattr(jo.step, f)),
                                      err_msg=f)
    for f in tfsm.NoiseFsmOut._fields:
        np.testing.assert_array_equal(getattr(host.noise, f), np.asarray(getattr(jo.noise, f)),
                                      err_msg=f"noise {f}")
