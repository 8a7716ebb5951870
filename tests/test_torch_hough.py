"""Exact Hough backend parity: the port's ops/hough.py and the exact
hysteresis of ops/canny.py vs the JAX package's, on the CPU.

Inputs are squares made from a seed: fixtures.make_square discs and the
blurred gray squares of rendered 1280x720 frames (flat and textured
boards). The JAX functions run jitted, as the pipeline's step runs them, so
XLA's fused multiply-adds decide the f32 rounding the port reproduces.
Accumulators, found, votes and centers must be bit-equal; radii are held
within RADIUS_ATOL and their floor (the pipeline's radius) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessboard_vision_tpu import geometry as jgeo
from chessboard_vision_tpu.models.pipeline import VisionPipeline as JaxPipeline
from chessboard_vision_tpu.ops import canny as jcanny
from chessboard_vision_tpu.ops import filters as jfilters
from chessboard_vision_tpu.ops import hough as jh
from chessboard_vision_tpu_torch.ops import canny as tcanny
from chessboard_vision_tpu_torch.ops import filters as tfilters
from chessboard_vision_tpu_torch.ops import hough as th

from fixtures import (
    DEFAULT_CORNERS,
    initial_occupancy,
    make_board_frame,
    make_hard_board_frame,
    make_square,
)

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

# Radii are square roots of the f32 distances XLA contracts; the port
# rounds them the same way (and has matched bit for bit on these scenes).
# One ulp of a radius below 64 px is 3.8e-6.
RADIUS_ATOL = 4e-6


def _discs(seed=5, n=64, size=77):
    """n squares: discs of several radii, contrasts and offsets, plus empty
    squares, as tests/test_hough_conv.py draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        radius = [None, 12, 18, 24, 30, 36][i % 6]
        out.append(make_square(rng, radius=radius, contrast=int(rng.integers(30, 110)),
                               off=tuple(int(v) for v in rng.integers(-6, 7, 2)), size=size))
    return np.stack(out)


@pytest.fixture(scope="module")
def scenes():
    """name -> (64, H, W) u8 blurred gray squares and the geometry's
    (heights, widths)."""
    g = jgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    jp = JaxPipeline(g, hough_backend="exact", donate_state=False)
    prep = jax.jit(jp._preprocess)
    rng = np.random.default_rng(40)
    occ = initial_occupancy()
    occ[4, 1], occ[4, 3] = False, True
    frames = {"flat": make_board_frame(occ, rng), "textured": make_hard_board_frame(occ, rng, t=0.6)}
    s = g.squares
    out = {name: (np.array(prep(jnp.asarray(f), jp._consts)[0]), s.heights, s.widths)
           for name, f in frames.items()}
    discs = _discs()
    sizes = np.full(64, discs.shape[1], np.int32)
    out["discs"] = (discs, sizes, sizes)
    return out


def _params(heights, widths):
    jp, jb = jh.HoughParams.from_geometry(heights, widths)
    tp, tb = th.HoughParams.from_geometry(heights, widths, device="cpu")
    return jp, jb, tp, tb


@pytest.mark.parametrize("ratios", [(0.20, 0.55), (0.25, 0.45)])
def test_params_and_bounds_equal_jax(ratios):
    g = jgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    hs, ws = g.squares.heights, g.squares.widths
    jp, jb = jh.HoughParams.from_geometry(hs, ws, min_ratio=ratios[0], max_ratio=ratios[1])
    tp, tb = th.HoughParams.from_geometry(hs, ws, min_ratio=ratios[0], max_ratio=ratios[1],
                                         device="cpu")
    assert tuple(tb) == tuple(jb)
    for f in jh.HoughParams._fields:
        t, j = getattr(tp, f).numpy(), np.asarray(getattr(jp, f))
        assert t.dtype == j.dtype, f
        np.testing.assert_array_equal(t, j, err_msg=f)


@pytest.mark.parametrize("compact", [True, False], ids=["voters_gathered", "every_pixel"])
@pytest.mark.parametrize("name", ["flat", "textured", "discs"])
def test_vote_accumulators_bit_equal(scenes, name, compact):
    """Both voting forms (voting pixels gathered first, the CPU's; a lane
    for every pixel, the card's) give the JAX package's i32 accumulators."""
    gray, hs, ws = scenes[name]
    jp, jb, tp, tb = _params(hs, ws)
    jedges = jcanny.canny(jnp.asarray(gray), 50, 100)
    jdx, jdy = jfilters.sobel3(jnp.asarray(gray), border="reflect101")
    want = np.asarray(jax.jit(jh._vote, static_argnums=(4, 5))(jedges, jdx, jdy, jp, jb, 1.2))
    tdx, tdy = tfilters.sobel3(torch.from_numpy(gray), border="reflect101")
    got = th._vote(torch.from_numpy(np.array(jedges)), tdx, tdy, tp, tb, 1.2, compact=compact)
    assert got.dtype == torch.int32 and want.max() > 25
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["flat", "textured", "discs"])
def test_hough_circles_and_best_circle_match_jax(scenes, name):
    gray, hs, ws = scenes[name]
    jp, jb, tp, tb = _params(hs, ws)
    jc = jh.hough_circles(jnp.asarray(gray), jp, jb)
    tc = th.hough_circles(torch.from_numpy(gray), tp, tb)
    for f in ("found", "votes", "cx", "cy"):
        t, j = getattr(tc, f).numpy(), np.asarray(getattr(jc, f))
        assert t.dtype == j.dtype and t.shape == j.shape == (64, 4), f
        np.testing.assert_array_equal(t, j, err_msg=f)
    np.testing.assert_allclose(tc.radius.numpy(), np.asarray(jc.radius), rtol=0, atol=RADIUS_ATOL)
    np.testing.assert_array_equal(np.floor(tc.radius.numpy()), np.floor(np.asarray(jc.radius)))
    assert np.asarray(jc.found).sum() >= 16  # the scene's pieces are found

    jbest = jax.jit(jh.best_circle_near_center)(jc, jnp.asarray(hs), jnp.asarray(ws))
    tbest = th.best_circle_near_center(tc, torch.as_tensor(hs), torch.as_tensor(ws))
    for i, (t, j) in enumerate(zip(tbest, jbest)):
        assert t.dtype == torch.from_numpy(np.array(j)).dtype, i
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=f"output {i}")


def _chain_image(length):
    """A weak step edge (|Sobel| 80, between Canny's 50 and 100) ``length``
    px long whose left end is strong (|Sobel| 160): hysteresis reaches along
    it one pixel a dilation."""
    img = np.zeros((1, 12, length + 8), np.uint8)
    img[0, 6:, :] = 20
    img[0, 6:, :4] = 40
    return img


@pytest.mark.parametrize("length", [40, 600])
def test_exact_canny_follows_long_weak_chains_to_the_cap(length):
    """A chain longer than the conv path's 8 dilations, and one longer than
    the exact fixpoint's 256-dilation cap: bit-equal to the JAX package's
    exact Canny, which stops at the cap."""
    x = _chain_image(length)
    want = np.asarray(jcanny.canny(jnp.asarray(x), 50, 100))
    syncs = tcanny.canny.host_syncs
    got = tcanny.canny(torch.from_numpy(x), 50, 100).numpy()
    np.testing.assert_array_equal(got, want)
    assert tcanny.canny.host_syncs > syncs  # the fixpoint read its flag back
    bounded = np.asarray(jcanny.canny(jnp.asarray(x), 50, 100, hysteresis_rounds=2))
    uncapped = np.asarray(jcanny.canny(jnp.asarray(x), 50, 100, max_iters=10**6))
    assert bounded.sum() < want.sum()
    assert (want.sum() < uncapped.sum()) == (length > 256)


@pytest.mark.parametrize("first,growth", [(4, 1), (8, 2), (256, 2)])
def test_exact_canny_block_schedule_does_not_change_edges(scenes, first, growth, monkeypatch):
    """Any block schedule of the exact fixpoint (the JAX package's every 4
    dilations, the default doubling blocks, all 256 at once) gives the same
    edges: dilations past the fixpoint change nothing."""
    textured = scenes["textured"][0]
    h, w = textured.shape[1:]
    gray = np.concatenate([textured, _discs(seed=9, n=8, size=max(h, w))[:, :h, :w]])
    want = np.asarray(jcanny.canny(jnp.asarray(gray), 50, 100))
    monkeypatch.setattr(tcanny, "_FIRST_BLOCK", first)
    monkeypatch.setattr(tcanny, "_GROWTH", growth)
    np.testing.assert_array_equal(tcanny.canny(torch.from_numpy(gray), 50, 100).numpy(), want)
