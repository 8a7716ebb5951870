"""The port's CUDA kernels and device path on the card (marked ``cuda``).

Every test here needs an NVIDIA GPU and skips without one: a CUDA kernel
has no CPU mode. The module imports neither jax nor cv2, so it also runs
on a machine with only torch; there, skip the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from chessboard_vision_tpu_torch import geometry as geo
from chessboard_vision_tpu_torch.kernels import bilateral as kb
from chessboard_vision_tpu_torch.kernels import clahe as kc
from chessboard_vision_tpu_torch.kernels import score_matmul as sm
from chessboard_vision_tpu_torch.models import pipeline as tp
from chessboard_vision_tpu_torch.ops import enhance as tenh
from chessboard_vision_tpu_torch.ops import hough_conv as thc
from chessboard_vision_tpu_torch.tools.synth import SynthCamera, bench_corners, initial_occupancy

# bf16 products summed in f32 in another order: the tolerance of the JAX
# package's Pallas-vs-dot test (tests/test_hough_conv.py).
SCORE_RTOL, SCORE_ATOL = 2e-4, 2e-3
# The Hough basis at 1080p: (Mq, K) of the conv plan.
M_1080P, K_1080P = 7168, 3200

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k", [(512, 384), (2048, 1250), (7168, 3200), (100, 37), (33, 8)])
def test_score_matmul_kernel_vs_plain(cuda, m, k):
    """The kernel vs the plain version, including K not a multiple of the
    kernel's K-chunk (or of 8: the scalar staging path) and a ragged M."""
    g = torch.Generator(device=cuda).manual_seed(m + k)
    a = torch.randn(m, k, device=cuda, generator=g).to(torch.bfloat16)
    b = torch.randn(64, k, device=cuda, generator=g).to(torch.bfloat16)
    before = sm.score_matmul.launches
    got = sm.score_matmul(a, b)
    torch.cuda.synchronize()
    assert sm.score_matmul.launches == before + 1
    torch.testing.assert_close(got, sm.score_matmul_reference(a, b), rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("m,k,n", [
    (M_1080P, K_1080P, 128),  # two column tiles
    (M_1080P, K_1080P, 40),  # a ragged column tile
    (1000, K_1080P, 64),  # rows not a multiple of the 64-row tile
    (2048, 1250, 40),  # the staged kernel with a ragged column tile
])
def test_score_matmul_kernel_shapes(cuda, m, k, n):
    """Other widths N and a ragged M on the TMA kernel (K % 8 == 0) and the
    staged one (K % 8 != 0), against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a = torch.randn(m, k, device=cuda, generator=g).to(torch.bfloat16)
    b = torch.randn(n, k, device=cuda, generator=g).to(torch.bfloat16)
    got = sm.score_matmul(a, b)
    torch.cuda.synchronize()
    assert sm.score_matmul.last_path == ("tma" if k % 8 == 0 else "staged")
    torch.testing.assert_close(got, sm.score_matmul_reference(a, b), rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_score_matmul_launches_are_bit_equal(cuda):
    """No atomics and no split of K: two launches on the same operands give
    the same scores, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(7)
    a = torch.randn(M_1080P, K_1080P, device=cuda, generator=g).to(torch.bfloat16)
    b = torch.randn(64, K_1080P, device=cuda, generator=g).to(torch.bfloat16)
    first, second = sm.score_matmul(a, b), sm.score_matmul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_score_matmul_path_by_shape_and_alignment(cuda):
    """The 1080p shapes take the TMA kernel; K % 8 != 0 and an operand that
    is not 16-byte aligned take the staged one, with the same results."""
    g = torch.Generator(device=cuda).manual_seed(8)
    b = torch.randn(64, K_1080P, device=cuda, generator=g).to(torch.bfloat16)
    a = torch.randn(M_1080P, K_1080P, device=cuda, generator=g).to(torch.bfloat16)
    before = sm.score_matmul.launches
    sm.score_matmul(a, b)
    assert sm.score_matmul.last_path == "tma" and sm.score_matmul.launches == before + 1
    sm.score_matmul(a[:, :37].contiguous(), b[:, :37].contiguous())
    assert sm.score_matmul.last_path == "staged"
    # A contiguous view two bytes into its storage: TMA cannot take it.
    flat = torch.empty(256 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    shifted = flat[1:].view(256, 64)
    shifted.copy_(a[:256, :64])
    assert shifted.data_ptr() % 16 != 0
    got = sm.score_matmul(shifted, b[:, :64].contiguous())
    torch.cuda.synchronize()
    assert sm.score_matmul.last_path == "staged"
    torch.testing.assert_close(got, sm.score_matmul_reference(shifted, b[:, :64]),
                               rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_score_matmul_refuses_bad_inputs(cuda):
    a = torch.zeros(64, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        sm.score_matmul(a.float(), a)
    with pytest.raises(ValueError, match="K mismatch"):
        sm.score_matmul(a, a[:, :16].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        sm.score_matmul(a.t(), a)
    with pytest.raises(ValueError, match="expected CUDA"):
        sm.score_matmul(a, a.cpu())


def test_pipeline_on_card_matches_cpu(cuda):
    """Two 1280x720 frames through the port on the card and on the CPU:
    bool/i32 outputs equal, f32 outputs close, and the kernel launched."""
    h, w = 720, 1280
    corners = bench_corners(h, w)
    g = geo.BoardGeometry.from_calibration(corners, display_size=(w, h))
    cam = SynthCamera(corners, frame_size=(h, w), board_px=g.board_size)
    rng = np.random.default_rng(3)
    occ = initial_occupancy()
    frames = [cam.render(occ, rng) for _ in range(3)]
    outs = {}
    for dev in ("cpu", "cuda"):
        pipe = tp.VisionPipeline(g, device=dev)
        st = pipe.capture_reference(pipe.init_state(), frames[0])
        seq = []
        for fr in frames[1:]:
            st, o = pipe.step(st, fr)
            seq.append(tp.outputs_to_numpy(o))
        outs[dev] = seq
    for c, d in zip(outs["cpu"], outs["cuda"]):
        for f in tp.StepOutputs._fields:
            x, y = getattr(c, f), getattr(d, f)
            if x.dtype == np.float32:
                # score sums and float reductions run in another order
                np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-3, err_msg=f)
            else:
                np.testing.assert_array_equal(y, x, err_msg=f)
    truth = {(f, r) for f in range(8) for r in range(8) if occ[f, r]}
    assert tp.occupancy_to_set(outs["cuda"][-1].occupancy) == truth


def test_find_circle_on_card_matches_cpu(cuda):
    """Decisions of the conv detector on the card equal the CPU port's on
    discs of many radii and offsets."""
    rng = np.random.default_rng(9)
    size = 48
    yy, xx = np.mgrid[:size, :size]
    imgs = []
    for i in range(64):
        img = np.full((size, size), 120.0)
        if i % 4:
            r = rng.integers(11, 24)
            cy, cx = size // 2 + rng.integers(-5, 6), size // 2 + rng.integers(-5, 6)
            img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] += rng.integers(45, 110)
        imgs.append(np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8))
    imgs = torch.as_tensor(np.stack(imgs))
    h = np.full(64, size)
    res = {}
    for dev in ("cpu", "cuda"):
        plan, dims = thc.ConvHoughPlan.build(h, h, hysteresis_rounds=2, device=dev)
        res[dev] = thc.find_circle(imgs.to(dev), plan, dims)
    for f in ("found", "cx", "cy", "radius", "votes"):
        np.testing.assert_array_equal(
            getattr(res["cuda"], f).cpu().numpy(), getattr(res["cpu"], f).numpy(), err_msg=f
        )
    np.testing.assert_allclose(
        res["cuda"].score.cpu().numpy(), res["cpu"].score.numpy(), rtol=SCORE_RTOL, atol=SCORE_ATOL
    )


@pytest.mark.parametrize("shape,seed", [((3, 980, 980), 0), ((3, 77, 77), 1), ((3, 37, 1000), 2)])
def test_bilateral_kernel_vs_plain(cuda, shape, seed):
    """Bit-equal: the kernel and its plain version round the same f32
    operations in the same order, and the kernel's color weights are the
    card's expf of the same products. (3, 980, 980) is the 1080p board; odd
    shapes exercise the ragged blocks and the reflect-101 halo."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    img = torch.randint(0, 256, shape, device=cuda, generator=g, dtype=torch.uint8)
    before = kb.bilateral_planar.launches
    got = kb.bilateral_planar(img)
    torch.cuda.synchronize()
    assert kb.bilateral_planar.launches == before + 1
    assert torch.equal(got, kb.bilateral_reference(img))


def test_bilateral_color_table_equals_torch_exp(cuda):
    """The kernel's table of exp((cd * cd) * gc), built once by the card's
    expf, equals torch.exp on the card for all 766 color distances, and a
    second request returns the cached table."""
    table = kb.color_weight_table(cuda)
    assert table.shape == (kb.CD_LEVELS,)
    assert torch.equal(table, kb.color_weight_table_reference(device=cuda))
    assert kb.color_weight_table(cuda).data_ptr() == table.data_ptr()


def _padded(cuda, h, w, tiles, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    th, tw = -(-h // tiles), -(-w // tiles)
    img = torch.randint(0, 256, (th * tiles, tw * tiles), device=cuda, generator=g,
                        dtype=torch.uint8)
    return img, th, tw


# (984, 984): the 1080p Lab-L pad; th = 5 and th = 1 are the JAX package's
# v1 fallbacks (th = 1 stages 64 KB of LUTs: the >48 KB opt-in); 4x4 tiles.
CLAHE_SHAPES = [(984, 984, 8), (40, 64, 8), (8, 8, 8), (50, 33, 4)]


@pytest.mark.parametrize("h,w,tiles", CLAHE_SHAPES)
def test_clahe_hist_kernel_bit_equal(cuda, h, w, tiles):
    img, th, tw = _padded(cuda, h, w, tiles, h + w)
    got = kc.clahe_hist(img, th, tw, tiles)
    torch.cuda.synchronize()
    assert torch.equal(got, kc.clahe_hist_reference(img, th, tw, tiles))


@pytest.mark.parametrize("h,w,tiles", CLAHE_SHAPES)
def test_clahe_apply_kernel_bit_equal(cuda, h, w, tiles):
    img, th, tw = _padded(cuda, h, w, tiles, h * w)
    area = th * tw
    luts = tenh.clahe_luts_from_hist(kc.clahe_hist(img, th, tw, tiles), area,
                                     max(int(3.0 * area / 256), 1))
    got = kc.clahe_apply(img, luts, th, tw, tiles)
    torch.cuda.synchronize()
    assert torch.equal(got, kc.clahe_apply_reference(img, luts, th, tw, tiles))


def test_enhancement_kernels_refuse_bad_inputs(cuda):
    img = torch.zeros((3, 32, 32), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="uint8"):
        kb.bilateral_planar(img.float())
    with pytest.raises(ValueError, match="d=9"):
        kb.bilateral_planar(img, d=5)
    with pytest.raises(ValueError, match="tiles"):
        kc.clahe_hist(img[0], 3, 4, 8)
    with pytest.raises(ValueError, match="float32"):
        kc.clahe_apply(img[0], torch.zeros((64, 256), device=cuda, dtype=torch.int32), 4, 4, 8)
    with pytest.raises(ValueError, match="luts on cpu"):
        kc.clahe_apply(img[0], torch.zeros((64, 256)), 4, 4, 8)


def test_enhanced_pipeline_on_card_matches_cpu(cuda):
    """The enhanced pipeline on the card and on the CPU, 1280x720 frames:
    bool/i32 outputs equal, f32 outputs close, and every kernel launched."""
    h, w = 720, 1280
    corners = bench_corners(h, w)
    g = geo.BoardGeometry.from_calibration(corners, display_size=(w, h))
    cam = SynthCamera(corners, frame_size=(h, w), board_px=g.board_size)
    rng = np.random.default_rng(4)
    occ = initial_occupancy()
    frames = [cam.render(occ, rng) for _ in range(3)]
    counters = (sm.score_matmul, kb.bilateral_planar, kc.clahe_hist, kc.clahe_apply)
    before = [c.launches for c in counters]
    outs = {}
    for dev in ("cpu", "cuda"):
        pipe = tp.VisionPipeline(g, with_enhancer=True, device=dev)
        st = pipe.capture_reference(pipe.init_state(), frames[0])
        seq = []
        for fr in frames[1:]:
            st, o = pipe.step(st, fr)
            seq.append(tp.outputs_to_numpy(o))
        outs[dev] = seq
    assert all(c.launches > b for c, b in zip(counters, before))
    for c, d in zip(outs["cpu"], outs["cuda"]):
        for f in tp.StepOutputs._fields:
            x, y = getattr(c, f), getattr(d, f)
            if x.dtype == np.float32:
                # the bilateral's ulp-level exp differences reach a few
                # pixels of the squares' means
                np.testing.assert_allclose(y, x, rtol=1e-4, atol=0.05, err_msg=f)
            else:
                np.testing.assert_array_equal(y, x, err_msg=f)
    truth = {(f, r) for f in range(8) for r in range(8) if occ[f, r]}
    assert tp.occupancy_to_set(outs["cuda"][-1].occupancy) == truth
