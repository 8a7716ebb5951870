"""Per-op parity: the PyTorch port vs the JAX package on the same inputs.

The inputs are numpy arrays made from a seed; each goes through the JAX
function (on the CPU) and through its port on CPU tensors. u8/bool/i32
results must be bit-equal; f32 results agree within the tolerance stated
at each assertion.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chessboard_vision_tpu import geometry as geo
from chessboard_vision_tpu.ops import canny as jcanny
from chessboard_vision_tpu.ops import change as jchange
from chessboard_vision_tpu.ops import color as jcolor
from chessboard_vision_tpu.ops import filters as jfilters
from chessboard_vision_tpu.ops import hough_conv as jhc
from chessboard_vision_tpu.ops import matmul_resample as jmr
from chessboard_vision_tpu.ops import piece as jpiece
from chessboard_vision_tpu.ops.static_resample import to_planar as jto_planar
from chessboard_vision_tpu_torch.ops import canny as tcanny
from chessboard_vision_tpu_torch.ops import change as tchange
from chessboard_vision_tpu_torch.ops import color as tcolor
from chessboard_vision_tpu_torch.ops import filters as tfilters
from chessboard_vision_tpu_torch.ops import hough_conv as thc
from chessboard_vision_tpu_torch.ops import layout as tlayout
from chessboard_vision_tpu_torch.ops import matmul_resample as tmr
from chessboard_vision_tpu_torch.ops import piece as tpiece

from fixtures import DEFAULT_CORNERS, initial_occupancy, make_board_frame

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

# f32 features whose sums run in another order than XLA's (std, ring
# means, extent): a few ulps of values up to ~255.
F32_RTOL, F32_ATOL = 1e-5, 1e-4


def T(x):
    return torch.as_tensor(np.array(x))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def scene():
    """Geometry, a rendered 1280x720 frame and its padded/blurred squares."""
    rng = np.random.default_rng(20)
    g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    occ = initial_occupancy()
    occ[4, 1], occ[4, 3] = False, True
    frame = make_board_frame(occ, rng)
    planar = jto_planar(frame)
    qx, qy = g.square_query_coords()
    jplan, jdims = jmr.build_plan(qx, qy, g.src_h, g.src_w)
    tplan, tdims = tmr.build_plan(qx, qy, g.src_h, g.src_w, device="cpu")
    gray_frame = np.asarray(jcolor.planar_bgr2gray(jnp.asarray(planar)))
    # Jitted like the pipeline's step: XLA's fusion decides the f32
    # multiply-add rounding the port reproduces.
    padded = np.asarray(
        jax.jit(lambda x, p: jmr.resample_gray_u8(x, p, jdims))(jnp.asarray(gray_frame), jplan)
    )
    gray = np.asarray(jfilters.gaussian_blur_valid(jnp.asarray(padded), 5, pad=2))
    return dict(g=g, frame=frame, planar=planar, gray_frame=gray_frame,
                jplan=jplan, jdims=jdims, tplan=tplan, tdims=tdims,
                padded=padded, gray=gray)


def test_to_planar_and_positions_to_mask():
    from chessboard_vision_tpu.ops.layout import positions_to_mask

    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tlayout.to_planar(frame), jto_planar(frame))
    pos = {(0, 0), (7, 7), (4, 3), (8, 1), (-1, 2)}
    np.testing.assert_array_equal(tlayout.positions_to_mask(pos), positions_to_mask(pos))


def test_bgr2gray_bit_equal():
    rng = np.random.default_rng(1)
    hwc = rng.integers(0, 256, (2, 31, 47, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        N(tcolor.bgr2gray(T(hwc))), np.asarray(jcolor.bgr2gray(jnp.asarray(hwc)))
    )
    planar = np.moveaxis(hwc, -1, -3).copy()
    np.testing.assert_array_equal(
        N(tcolor.planar_bgr2gray(T(planar))),
        np.asarray(jcolor.planar_bgr2gray(jnp.asarray(planar))),
    )


def test_resample_gray_u8_bit_equal(scene):
    got = N(tmr.resample_gray_u8(T(scene["gray_frame"]), scene["tplan"], scene["tdims"]))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, scene["padded"])


def test_resample_f32_matches_jax_rounding_order(scene):
    """The f32 samples themselves (before the u8 round) are bit-equal to the
    jitted JAX form: the port reproduces the fused multiply-add order in
    which XLA:CPU compiles the lerp."""
    dims = scene["jdims"]
    want = np.asarray(
        jax.jit(lambda x, p: jmr.resample(x, p, dims))(jnp.asarray(scene["gray_frame"]), scene["jplan"])
    )
    got = N(tmr.resample(T(scene["gray_frame"]), scene["tplan"], scene["tdims"]))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ksize,pad", [(5, 2), (5, 4), (7, 3), (3, 1)])
def test_gaussian_blur_valid_bit_equal(ksize, pad):
    rng = np.random.default_rng(ksize * 10 + pad)
    x = rng.integers(0, 256, (8, 21 + 2 * pad, 19 + 2 * pad), dtype=np.uint8)
    want = np.asarray(jfilters.gaussian_blur_valid(jnp.asarray(x), ksize, pad=pad))
    got = N(tfilters.gaussian_blur_valid(T(x), ksize, pad=pad))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tfilters.gaussian_kernel_u8(ksize), jfilters.gaussian_kernel_u8(ksize)
    )


@pytest.mark.parametrize("border", ["replicate", "reflect101"])
def test_sobel3_bit_equal(border, scene):
    x = scene["gray"][:16]
    jdx, jdy = jfilters.sobel3(jnp.asarray(x), border=border)
    tdx, tdy = tfilters.sobel3(T(x), border=border)
    assert tdx.dtype == torch.int32
    np.testing.assert_array_equal(N(tdx), np.asarray(jdx))
    np.testing.assert_array_equal(N(tdy), np.asarray(jdy))


@pytest.mark.parametrize("rounds", [2, 0, -1])
def test_canny_bit_equal(rounds, scene):
    """Bounded hysteresis (2 rounds is the pipeline's conv path; 0 keeps
    only strong edges) and the exact fixpoint, on real squares plus noise
    squares whose weak chains are long."""
    rng = np.random.default_rng(3)
    x = np.concatenate(
        [scene["gray"][:24], rng.integers(0, 256, (8,) + scene["gray"].shape[1:], dtype=np.uint8)]
    )
    want = np.asarray(jcanny.canny(jnp.asarray(x), 50, 100, hysteresis_rounds=rounds))
    got = N(tcanny.canny(T(x), 50, 100, hysteresis_rounds=rounds))
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


def _change_inputs(seed, shape=(64, 21 * 23)):
    rng = np.random.default_rng(seed)
    means = (rng.random(shape) * 255).astype(np.float32)
    variances = (rng.random(shape) * 400 + 5).astype(np.float32)
    calibrated = rng.random(shape[0]) < 0.9
    gray = np.clip(means + rng.normal(0, 30, shape), 0, 255).astype(np.uint8)
    valid = rng.random(shape) < 0.95
    counts = valid.sum(-1).astype(np.int32)
    return means, variances, calibrated, gray, valid, counts


def test_change_detect_parity():
    means, variances, calibrated, gray, valid, counts = _change_inputs(5)
    jd = jchange.detect(
        jchange.ChangeModelState(jnp.asarray(means), jnp.asarray(variances), jnp.asarray(calibrated)),
        jnp.asarray(gray), 2.5, jnp.asarray(valid), jnp.asarray(counts),
    )
    td = tchange.detect(
        tchange.ChangeModelState(T(means), T(variances), T(calibrated)),
        T(gray), 2.5, T(valid), T(counts),
    )
    for f in ("changed_counts", "intensity", "significant"):
        np.testing.assert_array_equal(N(getattr(td, f)), np.asarray(getattr(jd, f)), err_msg=f)
    assert td.intensity.dtype == torch.int32 and td.changed_counts.dtype == torch.int32
    # XLA:CPU's f32 sqrt/divide are not always correctly rounded: z may
    # differ by an ulp.
    np.testing.assert_allclose(N(td.z_peak), np.asarray(jd.z_peak), rtol=1e-6)
    np.testing.assert_array_equal(N(td.pct_changed), np.asarray(jd.pct_changed))
    for x, y in zip(
        tchange.classify_hand_pattern(td.intensity, T(calibrated)),
        jchange.classify_hand_pattern(jd.intensity, jnp.asarray(calibrated)),
    ):
        np.testing.assert_array_equal(N(x), np.asarray(y))


def test_change_update_and_calibrate_parity():
    """The EMA update over 10 frames: the port reproduces the fused
    multiply-add rounding of the jitted JAX update, so the f32 state is
    bit-equal on the CPU."""
    means, variances, calibrated, gray, valid, counts = _change_inputs(6)
    rng = np.random.default_rng(7)
    js = jchange.calibrate(jnp.asarray(gray), 100.0)
    ts = tchange.calibrate(T(gray), 100.0)
    mask = rng.random(64) < 0.8
    update = jax.jit(lambda s, g, m: jchange.update_references(s, g, 0.1, m))
    for _ in range(10):
        g = np.clip(gray + rng.normal(0, 6, gray.shape), 0, 255).astype(np.uint8)
        js = update(js, jnp.asarray(g), jnp.asarray(mask))
        ts = tchange.update_references(ts, T(g), 0.1, T(mask))
    for f in ("means", "variances", "calibrated"):
        np.testing.assert_array_equal(N(getattr(ts, f)), np.asarray(getattr(js, f)), err_msg=f)


def test_detect_pieces_conv_parity(scene):
    g = scene["g"]
    s = g.squares
    H, W = int(s.heights.max()), int(s.widths.max())
    jmasks = jpiece.PieceMasks.build(s.heights, s.widths, H, W)
    tmasks = tpiece.PieceMasks.build(s.heights, s.widths, H, W, device="cpu")
    jplan, jdims = jhc.ConvHoughPlan.build(s.heights, s.widths, plane_h=H, plane_w=W, hysteresis_rounds=2)
    tplan, tdims = thc.ConvHoughPlan.build(s.heights, s.widths, plane_h=H, plane_w=W,
                                          hysteresis_rounds=2, device="cpu")
    gray = scene["gray"]
    jd = jpiece.detect_pieces(
        jnp.asarray(gray), jmasks, None, None,
        hough_backend="conv", conv_plan=jplan, conv_dims=jdims,
    )
    td = tpiece.detect_pieces(T(gray), tmasks, tplan, tdims)
    for f in ("has_piece", "method", "radius", "center_x", "center_y",
              "center_mean", "border_mean", "center_border_diff"):
        np.testing.assert_array_equal(N(getattr(td, f)), np.asarray(getattr(jd, f)), err_msg=f)
    for f in ("confidence", "std", "symmetry", "extent"):
        np.testing.assert_allclose(
            N(getattr(td, f)), np.asarray(getattr(jd, f)), rtol=F32_RTOL, atol=F32_ATOL, err_msg=f
        )
    assert td.method.dtype == torch.int32 and td.radius.dtype == torch.int32
