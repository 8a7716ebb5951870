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
# The Hough basis at 1080p: (Mq, K) of the conv plan; at 720p the card's
# plans pad K = 1250 to 1256, with Mq 2048 (3840 at the radius extremes).
M_1080P, K_1080P = 7168, 3200
K_720P = 1256
PLANS = [(M_1080P, K_1080P), (2048, K_720P), (3840, K_720P)]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k", [(512, 384), (2048, 1256), (3840, 1256), (7168, 3200), (100, 40),
                                 (33, 8)])
def test_score_matmul_kernel_vs_plain(cuda, m, k):
    """The kernel vs the plain version, including K not a multiple of the
    kernel's 64-wide K tile and a ragged M."""
    g = torch.Generator(device=cuda).manual_seed(m + k)
    a = torch.randn(m, k, device=cuda, generator=g).to(torch.bfloat16)
    b = torch.randn(64, k, device=cuda, generator=g).to(torch.bfloat16)
    before = sm.score_matmul.launches
    got = sm.score_matmul(a, b)
    torch.cuda.synchronize()
    assert sm.score_matmul.launches == before + 1
    torch.testing.assert_close(got, sm.score_matmul_reference(a, b), rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("m,k,n", [
    (M_1080P, K_1080P, 128),  # two sub-tiles a CTA
    (M_1080P, K_1080P, 40),  # a ragged column tile
    (M_1080P, K_1080P, 320),  # 5 sub-tiles: two column tiles of 3, the second ragged
    (1000, K_1080P, 64),  # rows not a multiple of the 64-row tile
    (2048, K_720P, 40),  # the 720p plans (K padded to 1256), ragged columns
    (2048, K_720P, 64),
    (2048, K_720P, 256),  # the fleet workers' 4 streams at 720p
    (3840, K_720P, 40),
    (3840, K_720P, 64),
    (3840, K_720P, 256),
    (2000, K_1080P, 320),  # a ragged last row tile of a 128-row CTA
])
def test_score_matmul_kernel_shapes(cuda, m, k, n):
    """Other widths N, a ragged M and the 720p plans against the plain
    version, on the TMA kernel."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a = torch.randn(m, k, device=cuda, generator=g).to(torch.bfloat16)
    b = torch.randn(n, k, device=cuda, generator=g).to(torch.bfloat16)
    got = sm.score_matmul(a, b)
    torch.cuda.synchronize()
    assert sm.score_matmul.last_path == "tma"
    torch.testing.assert_close(got, sm.score_matmul_reference(a, b), rtol=SCORE_RTOL, atol=SCORE_ATOL)


@pytest.mark.parametrize("m,k", PLANS)
@pytest.mark.parametrize("n", [64, 256])
def test_score_matmul_launches_are_bit_equal(cuda, m, k, n):
    """No atomics and no split of K: two launches on the same operands give
    the same scores, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(7)
    a = torch.randn(m, k, device=cuda, generator=g).to(torch.bfloat16)
    b = torch.randn(n, k, device=cuda, generator=g).to(torch.bfloat16)
    first, second = sm.score_matmul(a, b), sm.score_matmul(a, b)
    torch.cuda.synchronize()
    assert sm.score_matmul.last_path == "tma"
    assert torch.equal(first, second)


@pytest.mark.parametrize("m,k", PLANS)
@pytest.mark.parametrize("streams", [4, 8, 16])
def test_score_matmul_wide_n_columns_equal_their_n64_launches(cuda, m, k, streams):
    """N = streams * 64 (the N-stream step): each stream's 64 columns are
    bit-equal to that stream's own N = 64 launch (a wide wgmma rounds each
    column as m64n64k16 does, over all of K whatever the CTA tile), at
    1080p and at the 720p plans, up to N = 1024."""
    g = torch.Generator(device=cuda).manual_seed(streams)
    a = torch.randn(m, k, device=cuda, generator=g).to(torch.bfloat16)
    b = torch.randn(streams * 64, k, device=cuda, generator=g).to(torch.bfloat16)
    wide = sm.score_matmul(a, b)
    assert sm.score_matmul.last_path == "tma"
    for s in range(streams):
        assert torch.equal(wide[:, s * 64:(s + 1) * 64], sm.score_matmul(a, b[s * 64:(s + 1) * 64]))
    torch.testing.assert_close(wide, sm.score_matmul_reference(a, b), rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_score_matmul_path_by_shape_and_alignment(cuda):
    """The 1080p and 720p plans take the TMA kernel ("tma"); K % 8 != 0 and
    an operand that is not 16-byte aligned are refused before any launch
    (no kernel takes them)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    b = torch.randn(64, K_1080P, device=cuda, generator=g).to(torch.bfloat16)
    a = torch.randn(M_1080P, K_1080P, device=cuda, generator=g).to(torch.bfloat16)
    before = sm.score_matmul.launches
    sm.score_matmul(a, b)
    assert sm.score_matmul.last_path == "tma" and sm.score_matmul.launches == before + 1
    sm.score_matmul(a[:2048, :K_720P].contiguous(), b[:, :K_720P].contiguous())
    assert sm.score_matmul.last_path == "tma"
    assert sm.score_matmul.last_shape == (2048, 64, K_720P)
    sm.score_matmul(a[:3840, :K_720P].contiguous(), b[:, :K_720P].contiguous())
    assert sm.score_matmul.last_path == "tma"
    with pytest.raises(ValueError, match="k_align=8"):
        sm.score_matmul(a[:, :1250].contiguous(), b[:, :1250].contiguous())
    # A contiguous view two bytes into its storage: TMA cannot take it.
    flat = torch.empty(256 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    shifted = flat[1:].view(256, 64)
    assert shifted.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte aligned"):
        sm.score_matmul(shifted, b[:, :64].contiguous())
    assert sm.score_matmul.launches == before + 3


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


@pytest.mark.parametrize("backend", ["conv", "exact"])
def test_pipeline_on_card_matches_cpu(cuda, backend):
    """Two 1280x720 frames through the port on the card and on the CPU,
    with each Hough backend named on both: bool/i32 outputs equal, f32
    outputs close."""
    h, w = 720, 1280
    corners = bench_corners(h, w)
    g = geo.BoardGeometry.from_calibration(corners, display_size=(w, h))
    cam = SynthCamera(corners, frame_size=(h, w), board_px=g.board_size)
    rng = np.random.default_rng(3)
    occ = initial_occupancy()
    frames = [cam.render(occ, rng) for _ in range(3)]
    outs = {}
    for dev in ("cpu", "cuda"):
        pipe = tp.VisionPipeline(g, hough_backend=backend, device=dev)
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


def test_multistream_on_card_matches_cpu(cuda):
    """Three 1280x720 streams in different positions through the N-stream
    pipeline on the card and on the CPU: bool/i32 outputs and the noise
    FSM's equal, f32 outputs close."""
    from chessboard_vision_tpu_torch.parallel import multistream as tms

    h, w = 720, 1280
    corners = bench_corners(h, w)
    g = geo.BoardGeometry.from_calibration(corners, display_size=(w, h))
    cam = SynthCamera(corners, frame_size=(h, w), board_px=g.board_size)
    rng = np.random.default_rng(4)
    occ0 = initial_occupancy()
    occ1 = occ0.copy()
    occ1[4, 1], occ1[4, 3] = False, True
    ref = np.stack([cam.render(occ0, rng) for _ in range(3)])
    ticks = [np.stack([cam.render(o, rng) for o in (occ0, occ1, occ0)]) for _ in range(2)]
    outs = {}
    for dev in ("cpu", "cuda"):
        ms = tms.MultiStreamPipeline(g, 3, hough_backend="conv", device=dev)
        st = ms.capture_reference(ms.init_state(), ref)
        seq = []
        for t, frames in enumerate(ticks):
            st, o = ms.step(st, frames, s2c_masks=np.ones((3, 64), bool),
                            refresh=[t == 1, False, True])
            seq.append(tms.outputs_to_numpy(o))
        outs[dev] = seq
    for c, d in zip(outs["cpu"], outs["cuda"]):
        for part in ("step", "noise"):
            for f in getattr(c, part)._fields:
                x, y = getattr(getattr(c, part), f), getattr(getattr(d, part), f)
                if x.dtype == np.float32:
                    np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-3, err_msg=f)
                else:
                    np.testing.assert_array_equal(y, x, err_msg=f)
    assert tp.occupancy_to_set(outs["cuda"][-1].step.occupancy[1]) == {
        (f, r) for f in range(8) for r in range(8) if occ1[f, r]}


def test_multistream_takes_frames_on_the_card(cuda):
    """capture_reference, step_chunk and step given the frames as tensors
    already on the card (planar and HWC) give the outputs and states of the
    same frames as host arrays, bit for bit."""
    from chessboard_vision_tpu_torch.parallel import multistream as tms

    h, w = 720, 1280
    corners = bench_corners(h, w)
    g = geo.BoardGeometry.from_calibration(corners, display_size=(w, h))
    cam = SynthCamera(corners, frame_size=(h, w), board_px=g.board_size)
    rng = np.random.default_rng(5)
    occ1 = initial_occupancy()
    occ1[4, 1], occ1[4, 3] = False, True
    ref = np.stack([cam.render(initial_occupancy(), rng) for _ in range(2)])
    chunk = np.stack([np.stack([cam.render(o, rng) for o in (initial_occupancy(), occ1)])
                      for _ in range(3)])
    for planar in (False, True):
        r, c = (np.ascontiguousarray(np.moveaxis(x, -1, -3)) if planar else x
                for x in (ref, chunk))
        ms = tms.MultiStreamPipeline(g, 2, device=cuda)
        runs = []
        for frames in (np.asarray, lambda x: torch.as_tensor(x, device=cuda)):
            st = ms.capture_reference(ms.init_state(), frames(r))
            st, many = ms.step_chunk(st, frames(c))
            st, one = ms.step(st, frames(c[0]), s2c_masks=np.ones((2, 64), bool))
            runs.append((tms.multistream_state_to_numpy(st), tms.outputs_to_numpy(many),
                         tms.outputs_to_numpy(one)))
        leaves = [list(_host_leaves(run)) for run in runs]
        assert len(leaves[0]) == len(leaves[1]) > 30
        for (path, x), (_, y) in zip(*leaves):
            assert x.dtype == y.dtype and np.array_equal(x, y), (planar, path)


def _host_leaves(tree, path=""):
    """(path, array) of every numpy leaf of nested tuples and NamedTuples."""
    if isinstance(tree, np.ndarray):
        yield path, tree
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        for name, sub in zip(names, tree):
            yield from _host_leaves(sub, f"{path}.{name}")


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


# Unpadded planes: the 1080p board (980 = 4 * 245: 4-byte rows, not 16),
# widths that are not a multiple of 4, th < 8, 4x4 tiles, and a plane
# padded by 7 rows and 1 column.
UNPADDED_SHAPES = [(980, 980, 8), (77, 90, 8), (61, 83, 8), (37, 1001, 8), (50, 33, 4),
                   (977, 983, 8)]
# (h, w, tiles, constant value or None for random u8): the padded shapes,
# the unpadded ones, and constant planes (every pixel of a tile in one bin:
# the worst case for the atomics and the largest clip excess).
HIST_LUT_CASES = ([(h, w, t, None) for h, w, t in dict.fromkeys(CLAHE_SHAPES + UNPADDED_SHAPES)]
                  + [(980, 980, 8, 77), (40, 64, 8, 255), (50, 33, 4, 0)])


def _plane(cuda, h, w, seed, constant=None):
    if constant is not None:
        return torch.full((h, w), constant, dtype=torch.uint8, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randint(0, 256, (h, w), device=cuda, generator=g, dtype=torch.uint8)


@pytest.mark.parametrize("h,w,tiles,constant", HIST_LUT_CASES)
def test_clahe_hist_luts_kernel_bit_equal(cuda, h, w, tiles, constant):
    """Histograms of the reflect pad and the LUTs built from them in one
    launch, bit-equal to the plain version (pad, bincount, torch LUT ops);
    a second launch gives the same bits."""
    img = _plane(cuda, h, w, h + 3 * w, constant)
    th, tw = -(-h // tiles), -(-w // tiles)
    clip = max(int(3.0 * th * tw / 256), 1)
    before = kc.clahe_hist_luts.launches
    hist, luts = kc.clahe_hist_luts(img, th, tw, tiles, clip)
    again = kc.clahe_hist_luts(img, th, tw, tiles, clip)
    torch.cuda.synchronize()
    assert kc.clahe_hist_luts.launches == before + 2
    want_hist, want_luts = kc.clahe_hist_luts_reference(img, th, tw, tiles, clip)
    assert torch.equal(hist, want_hist)
    assert torch.equal(luts, want_luts)
    assert torch.equal(again[0], hist) and torch.equal(again[1], luts)


def test_clahe_hist_calls_in_a_row_each_equal_plain(cuda):
    """Calls in a row on other planes and tile grids (4x4, then 8x8, then
    4x4 tiles) each equal their plain version, the histogram-only wrapper
    included: no launch leaves state that the next one reads."""
    for h, w, tiles, seed in ((50, 33, 4, 1), (980, 980, 8, 2), (61, 83, 8, 3), (50, 33, 4, 4)):
        img = _plane(cuda, h, w, seed)
        th, tw = -(-h // tiles), -(-w // tiles)
        hist, luts = kc.clahe_hist_luts(img, th, tw, tiles, 5)
        only = kc.clahe_hist(img, th, tw, tiles)
        torch.cuda.synchronize()
        want_hist, want_luts = kc.clahe_hist_luts_reference(img, th, tw, tiles, 5)
        assert torch.equal(hist, want_hist) and torch.equal(only, want_hist)
        assert torch.equal(luts, want_luts)


@pytest.mark.parametrize("h,w,tiles", UNPADDED_SHAPES)
def test_clahe_apply_kernel_unpadded(cuda, h, w, tiles):
    """The apply on the unpadded plane equals its plain version and the
    apply on the reflect pad, cropped; a plane one byte into its storage
    takes the byte path with the same result."""
    img = _plane(cuda, h, w, h * w)
    th, tw = -(-h // tiles), -(-w // tiles)
    _, luts = kc.clahe_hist_luts(img, th, tw, tiles, max(int(3.0 * th * tw / 256), 1))
    got = kc.clahe_apply(img, luts, th, tw, tiles)
    pad = kc.reflect_pad_end(img, th * tiles, tw * tiles)
    cropped = kc.clahe_apply(pad, luts, th, tw, tiles)[:h, :w]
    flat = torch.empty(h * w + 1, dtype=torch.uint8, device=cuda)
    shifted = flat[1:].view(h, w)
    shifted.copy_(img)
    assert shifted.data_ptr() % 4 != 0
    off = kc.clahe_apply(shifted, luts, th, tw, tiles)
    torch.cuda.synchronize()
    assert got.shape == (h, w)
    assert torch.equal(got, kc.clahe_apply_reference(img, luts, th, tw, tiles))
    assert torch.equal(got, cropped)
    assert torch.equal(off, got)


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
    with pytest.raises(ValueError, match="tiles"):
        kc.clahe_hist_luts(img[0], 3, 4, 8, 1)
    with pytest.raises(ValueError, match="tiles"):  # 7 * 5 rows of tiles before row 32
        kc.clahe_hist_luts(img[0], 5, 4, 8, 1)
    with pytest.raises(ValueError, match="tiles"):
        kc.clahe_apply(img[0], torch.zeros((64, 256), device=cuda), 4, 5, 8)
    with pytest.raises(ValueError, match="uint8"):
        kc.clahe_hist_luts(img[0].float(), 4, 4, 8, 1)


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
    counters = (sm.score_matmul, kb.bilateral_planar, kc.clahe_hist_luts, kc.clahe_apply)
    before = [c.launches for c in counters]
    outs = {}
    for dev in ("cpu", "cuda"):
        pipe = tp.VisionPipeline(g, with_enhancer=True, hough_backend="conv", device=dev)
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


@pytest.mark.parametrize("group", ["bilateral", "hist", "apply", "empty"])
def test_ablation_variants_launch(cuda, group):
    """tools/ablate_enhanced's instantiations: variant 0 (the production
    kernel through the variant entry) bit-equal to the plain version and
    to the wrapper; every other variant launches on the 980 x 980 shapes
    and writes its output's shape."""
    from chessboard_vision_tpu_torch.tools import ablate_enhanced as ab

    var = ab.Variants()
    g = torch.Generator(device=cuda).manual_seed(7)
    size, tiles = 980, ab.TILES
    th = tw = -(-size // tiles)
    clip = max(int(ab.CLIP_LIMIT * th * tw / 256), 1)
    if group == "bilateral":
        img = torch.randint(0, 256, (3, size, size), dtype=torch.uint8, device=cuda, generator=g)
        assert torch.equal(var.bilateral(0, img), kb.bilateral_reference(img))
        assert torch.equal(var.bilateral(0, img), kb.bilateral_planar(img))
        for v in ab.BILATERAL_VARIANTS.values():
            assert var.bilateral(v, img).shape == img.shape
    elif group == "hist":
        img = torch.randint(0, 256, (size, size), dtype=torch.uint8, device=cuda, generator=g)
        hist = torch.empty((tiles * tiles, 256), dtype=torch.int32, device=cuda)
        luts = torch.empty((tiles * tiles, 256), dtype=torch.float32, device=cuda)
        want_h, want_l = kc.clahe_hist_luts_reference(img, th, tw, tiles, clip)
        var.hist(0, img, th, tw, clip, hist, luts)
        assert torch.equal(hist, want_h) and torch.equal(luts, want_l)
        for v in ab.HIST_VARIANTS.values():
            var.hist(v, img, th, tw, clip, hist, luts)
        torch.cuda.synchronize()
    elif group == "apply":
        img = torch.randint(0, 256, (size, size), dtype=torch.uint8, device=cuda, generator=g)
        luts = torch.randint(0, 256, (tiles * tiles, 256), device=cuda, generator=g).float()
        assert torch.equal(var.apply(0, img, luts, th, tw),
                           kc.clahe_apply_reference(img, luts, th, tw, tiles))
        assert torch.equal(var.apply(ab.APPLY_VARIANTS["copy"], img, luts, th, tw), img)
        for v in ab.APPLY_VARIANTS.values():
            assert var.apply(v, img, luts, th, tw).shape == img.shape
    else:
        var.empty()
        torch.cuda.synchronize()


def test_enhancer_backends_on_card(cuda):
    """The backend seam on the card: "plain" runs the plain versions,
    bit-equal to the kernels ("kernel", and "auto" on the card), and
    launches nothing; a shape a kernel refuses raises under "auto" and
    "kernel" instead of falling back."""
    from chessboard_vision_tpu_torch.models import enhancer as tenhancer

    g = torch.Generator(device=cuda).manual_seed(8)
    img = torch.randint(0, 256, (3, 96, 128), dtype=torch.uint8, device=cuda, generator=g)
    before = (kb.bilateral_planar.launches, kc.clahe_hist_luts.launches, kc.clahe_apply.launches)
    plain = (tenhancer.bilateral(img, "plain"), tenh.clahe(img[0], backend="plain"))
    assert (kb.bilateral_planar.launches, kc.clahe_hist_luts.launches,
            kc.clahe_apply.launches) == before
    for backend in ("kernel", "auto"):
        assert torch.equal(tenhancer.bilateral(img, backend), plain[0])
        assert torch.equal(tenh.clahe(img[0], backend=backend), plain[1])
    tiny = img[:, :4, :4].contiguous()
    for backend in ("kernel", "auto"):
        with pytest.raises(ValueError):
            tenhancer.bilateral(tiny, backend)
        with pytest.raises(ValueError):
            tenh.clahe(tiny[0], backend=backend)
    assert tenhancer.bilateral(tiny, "plain").shape == tiny.shape
