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


@pytest.fixture(scope="module")
def squares():
    """Preprocessed (64, 77, 77) squares of a rendered 1280x720 frame and
    the pipeline's conv plan for that geometry."""
    rng = np.random.default_rng(30)
    g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    occ = initial_occupancy()
    occ[3, 1], occ[3, 3] = False, True
    planar = jnp.asarray(to_planar(make_board_frame(occ, rng)))
    qx, qy = g.square_query_coords()
    plan, dims = jmr.build_plan(qx, qy, g.src_h, g.src_w)
    padded = jax.jit(lambda x, p: jmr.resample_gray_u8(jcolor.planar_bgr2gray(x), p, dims))(planar, plan)
    gray = np.asarray(jfilters.gaussian_blur_valid(padded, 5, pad=2))
    s = g.squares
    H, W = gray.shape[1:]
    kw = dict(plane_h=H, plane_w=W, hysteresis_rounds=2)
    return gray, s.heights, s.widths, kw


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
    """The TMA kernel needs K % 8 == 0 (16-byte rows) and 16-byte aligned
    operands; anything else goes to the staged kernel."""
    a = torch.zeros(128, 3200, dtype=torch.bfloat16)
    b = torch.zeros(64, 3200, dtype=torch.bfloat16)
    assert tsm.uses_tma(a, b)
    assert not tsm.uses_tma(a[:, :1250].contiguous(), b[:, :1250].contiguous())
    shifted = torch.zeros(128 * 64 + 1, dtype=torch.bfloat16)[1:].view(128, 64)
    assert shifted.data_ptr() % 16 != 0
    assert not tsm.uses_tma(shifted, b[:, :64].contiguous())
