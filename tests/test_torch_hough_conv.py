"""Conv circle detector and its score matmul: the port vs the JAX package.

The score matmul's plain version (``score_matmul_reference``, what the
port runs on CPU tensors) is held against the TPU Pallas kernel itself,
run in interpret mode on the CPU, and against the XLA dot the JAX package
runs off the TPU. The hand-written CUDA kernel is held against the plain
version on the card in tests/test_torch_kernels.py.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chessboard_vision_tpu import geometry as geo
from chessboard_vision_tpu.ops import color as jcolor
from chessboard_vision_tpu.ops import filters as jfilters
from chessboard_vision_tpu.ops import hough_conv as jhc
from chessboard_vision_tpu.ops import matmul_resample as jmr
from chessboard_vision_tpu.ops.static_resample import to_planar
from chessboard_vision_tpu_torch.kernels import score_matmul as tsm
from chessboard_vision_tpu_torch.ops import hough_conv as thc

from chessboard_vision_tpu_torch.tools.synth import bench_corners

from fixtures import DEFAULT_CORNERS, initial_occupancy, make_board_frame, make_square

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

# bf16 products summed in f32 in another order than the reference: the
# tolerance of the JAX package's own Pallas-vs-dot test
# (tests/test_hough_conv.py).
SCORE_RTOL, SCORE_ATOL = 2e-4, 2e-3


def _bf16_operands(rng, m, k, n=64):
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    ta = torch.as_tensor(a).to(torch.bfloat16)
    tb = torch.as_tensor(b).to(torch.bfloat16)
    # both frameworks round f32 -> bf16 to nearest even
    np.testing.assert_array_equal(
        np.asarray(ja).astype(np.float32), ta.float().numpy()
    )
    return ja, jb, ta, tb


@pytest.mark.parametrize("m,k", [(512, 384), (256, 250)])
def test_score_matmul_reference_vs_pallas_interpret(m, k, monkeypatch):
    """The plain version vs the TPU Pallas kernel run in interpret mode."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(
        pl, "pallas_call",
        functools.partial(pl.pallas_call, interpret=pltpu.InterpretParams()),
    )
    ja, jb, ta, tb = _bf16_operands(np.random.default_rng(m + k), m, k)
    want = np.asarray(jhc._score_matmul_pallas(ja, jb.T))
    got = tsm.score_matmul_reference(ta, tb).numpy()
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)


def _board_squares(seed, corners=DEFAULT_CORNERS, frame_size=(720, 1280)):
    """Preprocessed (64, H, W) squares of a rendered frame, the square
    heights and widths, and the pipeline's conv plan arguments for that
    geometry."""
    rng = np.random.default_rng(seed)
    h, w = frame_size
    g = geo.BoardGeometry.from_calibration(corners, display_size=(w, h))
    occ = initial_occupancy()
    occ[3, 1], occ[3, 3] = False, True
    planar = jnp.asarray(to_planar(make_board_frame(occ, rng, corners, frame_size)))
    qx, qy = g.square_query_coords()
    plan, dims = jmr.build_plan(qx, qy, g.src_h, g.src_w)
    padded = jax.jit(lambda x, p: jmr.resample_gray_u8(jcolor.planar_bgr2gray(x), p, dims))(planar, plan)
    gray = np.asarray(jfilters.gaussian_blur_valid(padded, 5, pad=2))
    s = g.squares
    H, W = gray.shape[1:]
    kw = dict(plane_h=H, plane_w=W, hysteresis_rounds=2)
    return gray, s.heights, s.widths, kw


@pytest.fixture(scope="module")
def squares():
    """Preprocessed (64, 77, 77) squares of a rendered 1280x720 frame and
    the pipeline's conv plan for that geometry."""
    return _board_squares(30)


def test_score_matmul_reference_vs_xla_dot(squares):
    """At the pipeline's own shapes: the real basis of the 1280x720 plan and
    random bf16 planes, vs the XLA dot_general of hough_conv.py."""
    _, heights, widths, kw = squares
    jplan, _ = jhc.ConvHoughPlan.build(heights, widths, **kw)
    tplan, _ = thc.ConvHoughPlan.build(heights, widths, **kw)
    k = jplan.basis.shape[1]
    rng = np.random.default_rng(4)
    pf = rng.standard_normal((64, k)).astype(np.float32)
    want = np.asarray(
        jax.lax.dot_general(
            jplan.basis, jnp.asarray(pf, jnp.bfloat16), (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    )
    got = tsm.score_matmul_reference(tplan.basis, torch.as_tensor(pf).to(torch.bfloat16)).numpy()
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)


def _assert_circles_equal(tc, jc):
    for f in ("found", "cx", "cy", "radius", "votes"):
        np.testing.assert_array_equal(
            tc._asdict()[f].numpy(), np.asarray(jc._asdict()[f]), err_msg=f
        )
    np.testing.assert_allclose(
        tc.score.numpy(), np.asarray(jc.score), rtol=SCORE_RTOL, atol=SCORE_ATOL
    )
    assert tc.radius.dtype == torch.int32 and tc.found.dtype == torch.bool


def test_find_circle_parity_on_board_squares(squares):
    gray, heights, widths, kw = squares
    jplan, jdims = jhc.ConvHoughPlan.build(heights, widths, **kw)
    tplan, tdims = thc.ConvHoughPlan.build(heights, widths, **kw)
    jc = jhc.find_circle(jnp.asarray(gray), jplan, jdims)
    tc = thc.find_circle(torch.as_tensor(np.array(gray)), tplan, tdims)
    _assert_circles_equal(tc, jc)
    assert np.asarray(jc.found).sum() >= 20  # the board's pieces are found


@pytest.mark.parametrize("rounds", [2, -1])
def test_find_circle_parity_on_synthetic_squares(rounds):
    """Off-center circles of many radii and contrasts, and empty squares,
    with bounded and exact hysteresis."""
    rng = np.random.default_rng(40 + rounds)
    size = 48
    imgs = []
    for i in range(64):
        if i % 4 == 3:
            imgs.append(make_square(rng, radius=None, noise=int(rng.integers(1, 10)), size=size))
        else:
            imgs.append(make_square(
                rng, radius=int(rng.integers(11, 24)), contrast=int(rng.integers(45, 110)),
                noise=int(rng.integers(2, 10)),
                off=(int(rng.integers(-5, 6)), int(rng.integers(-5, 6))), size=size,
            ))
    imgs = np.stack(imgs)
    h = np.full(64, size)
    jplan, jdims = jhc.ConvHoughPlan.build(h, h, hysteresis_rounds=rounds)
    tplan, tdims = thc.ConvHoughPlan.build(h, h, hysteresis_rounds=rounds)
    _assert_circles_equal(
        thc.find_circle(torch.as_tensor(imgs), tplan, tdims),
        jhc.find_circle(jnp.asarray(imgs), jplan, jdims),
    )


def test_score_matmul_cpu_takes_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; a CPU/CUDA mix or a wrong dtype is refused before any launch."""
    rng = np.random.default_rng(5)
    _, _, ta, tb = _bf16_operands(rng, 64, 40)
    before = tsm.score_matmul.launches
    np.testing.assert_array_equal(
        tsm.score_matmul(ta, tb).numpy(), tsm.score_matmul_reference(ta, tb).numpy()
    )
    assert tsm.score_matmul.launches == before
    with pytest.raises(ValueError, match="expected CUDA"):
        tsm.score_matmul(ta.to("meta"), tb)
    with pytest.raises(ValueError, match="expected CUDA"):
        tsm.score_matmul(ta.to("meta"), tb.to("meta"))


def test_score_matmul_kernel_choice_by_shape_and_alignment():
    """The kernel reads both operands through TMA: K % 8 == 0 (16-byte
    rows) and 16-byte aligned operands pass, anything else is refused (no
    kernel takes it). The 1080p plan and the 720p plans' padded K = 1256
    take the one TMA kernel; its CTA tile grows with N where the rows leave
    the SMs room."""
    a = torch.zeros(128, 3200, dtype=torch.bfloat16)
    b = torch.zeros(64, 3200, dtype=torch.bfloat16)
    tsm.check_tma(a, b)
    tsm.check_tma(a[:, :1256].contiguous(), b[:, :1256].contiguous())
    with pytest.raises(ValueError, match="k_align=8"):
        tsm.check_tma(a[:, :1250].contiguous(), b[:, :1250].contiguous())
    shifted = torch.zeros(128 * 64 + 1, dtype=torch.bfloat16)[1:].view(128, 64)
    assert shifted.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="basis is not 16-byte aligned"):
        tsm.check_tma(shifted, b[:, :64].contiguous())
    # (64-row warpgroups, 64-column sub-tiles) a CTA at 1080p, by N
    shapes = {64: (1, 1), 40: (1, 1), 128: (1, 2), 256: (2, 2), 320: (2, 3), 512: (2, 4),
              1024: (2, 4)}
    for n, shape in shapes.items():
        assert tsm.tile_shape(7168, n, 132) == shape, n
    assert tsm.tile_shape(2048, 64, 132) == (1, 1)  # 720p: too few rows for more
    assert tsm.tile_shape(2048, 256, 132) == (1, 2)
    assert tsm.tile_shape(3840, 256, 132) == (1, 2)
    assert tsm.tile_shape(100_000, 64, 132) == (1, 1)  # N <= 64: one warpgroup always


# The (warpgroups, sub-tiles) that score_matmul.cu instantiates.
KERNEL_TILES = {(1, 1), (1, 2), (1, 3), (1, 4), (2, 2), (2, 3), (2, 4)}


@pytest.mark.parametrize("n", [64, 256, 512, 1024])
def test_score_matmul_tile_shape_is_a_kernel_tile(n):
    """At every plan's M and a range of N around n, tile_shape gives a tile
    the kernel instantiates; its column tiles cover N with no empty tile;
    and it is the largest of the candidates that gives three quarters of
    the SMs a CTA, or the smallest. Every CTA walks all of K whatever the
    tile, so N changes no score's bits (the card tests check it)."""
    sms = 132
    for m in (1024, 2048, 3840, 7168):
        for width in (n - 24, n, n + 40):
            wg, nt = tsm.tile_shape(m, width, sms)
            assert (wg, nt) in KERNEL_TILES, (m, width)
            subtiles = -(-width // 64)
            tiles = -(-subtiles // nt)
            assert (tiles - 1) * nt < subtiles <= tiles * nt, (m, width)
            if subtiles == 1:
                assert (wg, nt) == (1, 1)
                continue

            def fills(wg, nt):
                return 4 * -(-m // (64 * wg)) * -(-subtiles // nt) >= 3 * sms

            # each candidate as it applies to N: its sub-tiles spread evenly
            # over the fewest column tiles
            widths = {-(-subtiles // -(-subtiles // c)) for c in (4, 2)}
            larger = [(w, t) for w in (2, 1) for t in widths if w * t > wg * nt]
            if fills(wg, nt):
                assert not any(fills(*c) for c in larger), (m, width)
            else:  # none fills the card: the smallest
                assert wg == 1 and nt <= 2 and not any(fills(*c) for c in larger), (m, width)
    assert tsm.tile_shape(7168, n, sms)[0] == (1 if n == 64 else 2)


def test_k_align_follows_the_device():
    """Plans on the card pad K to a multiple of 8; CPU plans keep JAX's K."""
    assert thc.k_align_for("cuda") == thc.k_align_for(torch.device("cuda", 1)) == 8
    assert thc.k_align_for("cpu") == 1


@pytest.fixture(scope="module")
def squares_1080p():
    """Preprocessed squares of a rendered 1920x1080 frame on the benchmark's
    board layout, and the pipeline's conv plan arguments."""
    return _board_squares(31, bench_corners(1080, 1920), (1080, 1920))


@pytest.mark.parametrize("size", ["720p", "1080p"])
def test_padded_plan_find_circle_equals_unpadded_and_jax(size, squares, squares_1080p):
    """A plan padded to k_align = 8 (what the card builds) has zero basis
    columns after JAX's K and planes_flat the same zero tail; its circles
    equal the unpadded plan's and the JAX find_circle's (found, votes,
    centers, radii exactly; scores within the matmul tolerance)."""
    gray, heights, widths, kw = squares if size == "720p" else squares_1080p
    jplan, jdims = jhc.ConvHoughPlan.build(heights, widths, **kw)
    plan, dims = thc.ConvHoughPlan.build(heights, widths, **kw)
    padded, pdims = thc.ConvHoughPlan.build(heights, widths, k_align=8, **kw)
    k = plan.basis.shape[1]
    assert k == jplan.basis.shape[1] == {"720p": 1250, "1080p": 3200}[size]
    assert padded.basis.shape == (plan.basis.shape[0], -(-k // 8) * 8)
    assert torch.equal(padded.basis[:, :k], plan.basis)
    assert not padded.basis[:, k:].any()
    assert pdims == dims
    for f in plan._fields:
        if f != "basis":
            assert torch.equal(getattr(padded, f), getattr(plan, f)), f
    g = torch.as_tensor(np.array(gray))
    pf = thc.edge_planes(g, pdims, k=padded.basis.shape[1]).planes_flat
    assert torch.equal(pf[:, :k], thc.edge_planes(g, dims).planes_flat)
    assert not pf[:, k:].any()
    tc = thc.find_circle(g, padded, pdims)
    _assert_circles_equal(tc, jhc.find_circle(jnp.asarray(gray), jplan, jdims))
    unpadded = thc.find_circle(g, plan, dims)
    for f in ("found", "cx", "cy", "radius", "votes"):
        assert torch.equal(getattr(tc, f), getattr(unpadded, f)), f
    torch.testing.assert_close(tc.score, unpadded.score, rtol=SCORE_RTOL, atol=SCORE_ATOL)
    assert np.asarray(tc.found).sum() >= 20  # the board's pieces are found
    with pytest.raises(ValueError, match="below"):
        thc.edge_planes(g, dims, k=k - 2)
