"""Enhancement parity: the port's color, filter, threshold and enhancement
functions and its three enhancement kernels' plain versions vs the JAX
package on the CPU.

The JAX side is jitted (XLA:CPU's rounding is what the JAX package
computes on this machine). Where the JAX function reaches a Pallas kernel
it runs as the JAX package's own CPU tests run it, under
``pltpu.force_tpu_interpret_mode()``: the reference is what the TPU kernels
compute, not the XLA stand-ins that ``backend="auto"`` picks on a CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chessboard_vision_tpu.models import enhancer as jenh_model
from chessboard_vision_tpu.ops import color as jcolor
from chessboard_vision_tpu.ops import enhance as jenh
from chessboard_vision_tpu.ops import filters as jfilters
from chessboard_vision_tpu.ops import matmul_resample as jmr
from chessboard_vision_tpu.ops import threshold as jthreshold
from chessboard_vision_tpu.ops.pallas import bilateral as jbil
from chessboard_vision_tpu.ops.pallas import clahe_apply as jca
from chessboard_vision_tpu_torch import geometry as tgeo
from chessboard_vision_tpu_torch.kernels import bilateral as tbil
from chessboard_vision_tpu_torch.kernels import clahe as tclahe
from chessboard_vision_tpu_torch.models import enhancer as tenh_model
from chessboard_vision_tpu_torch.ops import color as tcolor
from chessboard_vision_tpu_torch.ops import enhance as tenh
from chessboard_vision_tpu_torch.ops import filters as tfilters
from chessboard_vision_tpu_torch.ops import matmul_resample as tmr
from chessboard_vision_tpu_torch.ops import threshold as tthreshold
from chessboard_vision_tpu_torch.tools.synth import SynthCamera, initial_occupancy, render_board

from fixtures import DEFAULT_CORNERS, make_board_frame

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

# f32 arithmetic before a u8 round: the port rounds each f32 operation as
# written, XLA:CPU may contract multiply-adds and evaluates exp, sqrt and
# divide with other ulps. Such stages agree within one level on at most
# this fraction of pixels (measured: Lab -> BGR 7.6e-6, HSV -> BGR 1.1e-5,
# the bilateral 5.4e-5 of 3x64x96).
ONE_LEVEL_FRACTION = 1e-4

PROFILE = {"hue_shift": 7, "sat_scale": 1.2, "val_scale": 0.9, "contrast": 1.3,
           "brightness": -7, "radical_mode": 1, "target_hue": 20, "hue_window": 25}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_within_one_level(got, want, fraction=ONE_LEVEL_FRACTION, what=""):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1, f"{what}: max diff {d.max()}"
    assert (d > 0).mean() <= fraction, f"{what}: {(d > 0).mean():.3g} of pixels differ"


@pytest.fixture(scope="module")
def colors():
    """Planar (3, 512, 512): a 64-level lattice of all colors, and random u8."""
    v = np.arange(1 << 18, dtype=np.uint32)
    lattice = np.stack([(v & 63) * 4 + 1, ((v >> 6) & 63) * 4 + 2, (v >> 12) * 4 + 3])
    rnd = np.random.default_rng(0).integers(0, 256, (3, 512, 512), np.uint8)
    return [lattice.astype(np.uint8).reshape(3, 512, 512), rnd]


# ---------------------------------------------------------------------------
# Color conversions (bit-equal where the JAX arithmetic is integer)
# ---------------------------------------------------------------------------


def test_gamma_and_cbrt_tables_equal_the_jax_polynomials():
    """The port looks the two Lab fixed-point functions up in tables; the JAX
    package evaluates them per pixel. Equal on every input."""
    x = jnp.arange(256, dtype=jnp.uint8)
    np.testing.assert_array_equal(
        tcolor._gamma_fixed(torch.arange(256, dtype=torch.uint8)).numpy(),
        np.asarray(jax.jit(jcolor._gamma_fixed)(x)),
    )
    idx = np.arange(jcolor._CBRT_N, dtype=np.int32)
    np.testing.assert_array_equal(
        tcolor._cbrt_fixed(_t(idx)).numpy(), np.asarray(jax.jit(jcolor._cbrt_fixed)(idx))
    )


@pytest.mark.parametrize("which", [0, 1], ids=["lattice", "random"])
def test_bgr_to_lab_and_hsv_bit_equal(colors, which):
    planar = colors[which]
    hwc = np.moveaxis(planar, 0, -1).copy()
    np.testing.assert_array_equal(
        tcolor.planar_bgr2lab(_t(planar)).numpy(),
        np.asarray(jax.jit(jcolor.planar_bgr2lab)(planar)),
    )
    np.testing.assert_array_equal(
        tcolor.bgr2lab(_t(hwc[:64])).numpy(), np.asarray(jax.jit(jcolor.bgr2lab)(hwc[:64]))
    )
    np.testing.assert_array_equal(
        tcolor.bgr2hsv(_t(hwc)).numpy(), np.asarray(jax.jit(jcolor.bgr2hsv)(hwc))
    )


@pytest.mark.parametrize("which", [0, 1], ids=["lattice", "random"])
def test_lab_and_hsv_to_bgr_within_one_level(colors, which):
    planar = colors[which]
    assert_within_one_level(
        tcolor.planar_lab2bgr(_t(planar)).numpy(),
        np.asarray(jax.jit(jcolor.planar_lab2bgr)(planar)), what="planar_lab2bgr",
    )
    hwc = np.moveaxis(planar, 0, -1).copy()
    np.testing.assert_array_equal(  # the HWC form equals the planar one
        tcolor.lab2bgr(_t(hwc)).numpy(),
        np.moveaxis(tcolor.planar_lab2bgr(_t(planar)).numpy(), 0, -1),
    )
    hwc[..., 0] %= 180
    assert_within_one_level(
        tcolor.hsv2bgr(_t(hwc)).numpy(), np.asarray(jax.jit(jcolor.hsv2bgr)(hwc)),
        what="hsv2bgr",
    )


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (1.3, -7.0), (0.8, 12.5), (2.1, 0.3)])
def test_convert_scale_abs_bit_equal(colors, alpha, beta):
    x = colors[1]
    want = jax.jit(lambda v: jcolor.convert_scale_abs(v, alpha, beta))(x)
    np.testing.assert_array_equal(
        tcolor.convert_scale_abs(_t(x), alpha, beta).numpy(), np.asarray(want)
    )


# ---------------------------------------------------------------------------
# Filters and Otsu
# ---------------------------------------------------------------------------


def test_sharpen_gaussian_and_otsu_bit_equal(colors):
    planar = colors[1][:, :200, :300]
    np.testing.assert_array_equal(
        tfilters.sharpen(_t(planar)).numpy(), np.asarray(jax.jit(jfilters.sharpen)(planar))
    )
    hwc = np.moveaxis(planar, 0, -1).copy()
    np.testing.assert_array_equal(
        tfilters.sharpen(_t(hwc)).numpy(), np.asarray(jax.jit(jfilters.sharpen)(hwc))
    )
    gray = colors[0][1]
    np.testing.assert_array_equal(
        tfilters.gaussian_blur(_t(gray), 5).numpy(),
        np.asarray(jax.jit(lambda g: jfilters.gaussian_blur(g, 5))(gray)),
    )
    for img in (gray, (colors[1][0] // 3 + 60).astype(np.uint8)):
        jt, jb = jax.jit(jthreshold.otsu_binarize)(img)
        tt, tb = tthreshold.otsu_binarize(_t(img))
        assert float(tt) == float(jt)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_normalize_minmax_within_one_level(colors):
    for img in ((colors[1] // 2 + 40).astype(np.uint8), colors[0][:, :100], np.full((4, 5), 9, np.uint8)):
        assert_within_one_level(
            tfilters.normalize_minmax(_t(img)).numpy(),
            np.asarray(jax.jit(jfilters.normalize_minmax)(img)), what="normalize_minmax",
        )


# ---------------------------------------------------------------------------
# The kernels' plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 64, 96), (3, 77, 77)])
def test_bilateral_plain_vs_pallas(shape):
    img = np.random.default_rng(shape[1]).integers(0, 256, shape, np.uint8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jbil.bilateral_planar_pallas(jnp.asarray(img)))
    got = tbil.bilateral_planar(_t(img)).numpy()
    assert_within_one_level(got, want, what=f"bilateral {shape}")


def _bilateral_table_form(img: torch.Tensor) -> torch.Tensor:
    """The bilateral kernel's arithmetic in torch: the color distance as an
    integer, its weight looked up in the 766-entry table, every sum started
    from its first term."""
    r = tbil.KERNEL_D // 2
    sw = tbil.space_weights(tbil.KERNEL_D, 75.0)
    table = tbil.color_weight_table_reference(75.0)
    _, h, w = img.shape
    p = tfilters._reflect101_pad(img, r).to(torch.int32)
    center = p[:, r : r + h, r : r + w]
    num = den = None
    for dy in range(tbil.KERNEL_D):
        rn = rd = None
        for dx in range(tbil.KERNEL_D):
            if sw[dy, dx] == 0.0:
                continue
            nb = p[:, dy : dy + h, dx : dx + w]
            wt = float(sw[dy, dx]) * table[(nb - center).abs().sum(0)]
            t = wt * nb.float()
            rn, rd = (t, wt) if rn is None else (rn + t, rd + wt)
        num, den = (rn, rd) if num is None else (num + rn, den + rd)
    return torch.round(num / den).clamp(0, 255).to(torch.uint8)


@pytest.mark.parametrize("shape", [(3, 64, 96), (3, 37, 50)])
def test_bilateral_table_form_equals_plain(shape):
    """The kernel's form (integer color distance, table lookup, sums from
    their first term, 49 taps) is the plain version's function, bit for bit."""
    img = torch.from_numpy(np.random.default_rng(shape[2]).integers(0, 256, shape, np.uint8))
    assert int((tbil.space_weights(tbil.KERNEL_D, 75.0) != 0).sum()) == 49
    assert torch.equal(_bilateral_table_form(img), tbil.bilateral_reference(img))


def _padded(h, w, tiles, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w), np.uint8)
    th, tw = -(-h // tiles), -(-w // tiles)
    pad = np.pad(img, ((0, th * tiles - h), (0, tw * tiles - w)), mode="reflect")
    return pad, th, tw


@pytest.mark.parametrize("h,w,tiles,version", [
    (160, 160, 8, "v3"), (77, 90, 8, "v3"), (160, 160, 8, "v1"),
    (40, 64, 8, "v1"), (50, 33, 4, "v1"),
])
def test_clahe_hist_plain_vs_pallas(h, w, tiles, version):
    """Bit-equal integer counts, vs v3 (th >= 8, 8x8 tiles) and vs v1 (any
    tiles, th < 8 included)."""
    pad, th, tw = _padded(h, w, tiles, h * w)
    with pltpu.force_tpu_interpret_mode():
        if version == "v3":
            want = jca.clahe_hist_pallas_v3(pad, th, tw, tiles, band=16 if th >= 16 else 8)
        else:
            want = jca.clahe_hist_pallas(pad, th, tw, tiles)
    got = tclahe.clahe_hist(_t(pad), th, tw, tiles)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("h,w,version", [
    (160, 160, "v2"), (77, 90, "v2"), (160, 160, "v1"), (40, 64, "v1"), (620, 620, "v2"),
])
def test_clahe_luts_and_apply_plain_vs_pallas(h, w, version):
    """The LUTs from the same histograms are equal, and the apply's u8
    output is bit-equal to the Pallas kernel's (v2 needs th >= 8; v1 is
    the JAX package's fallback below that). 620 is the 720p board."""
    tiles = 8
    pad, th, tw = _padded(h, w, tiles, h + w)
    hist = tclahe.clahe_hist(_t(pad), th, tw, tiles)
    area = th * tw
    clip_abs = max(int(3.0 * area / 256), 1)
    luts = tenh.clahe_luts_from_hist(hist, area, clip_abs)
    jluts = jax.jit(jenh.clahe_luts_from_hist, static_argnums=(1, 2))(hist.numpy(), area, clip_abs)
    np.testing.assert_array_equal(luts.numpy(), np.asarray(jluts))
    with pltpu.force_tpu_interpret_mode():
        fn = jca.clahe_apply_pallas_v2 if version == "v2" else jca.clahe_apply_pallas
        want = np.asarray(fn(pad, jluts, th, tw, tiles))
    np.testing.assert_array_equal(tclahe.clahe_apply(_t(pad), luts, th, tw, tiles).numpy(), want)


def test_clahe_vs_pallas_backend():
    """The port's clahe (pad, hist, LUTs, apply, crop) equals the JAX
    package's clahe(backend='pallas') on a non-square image."""
    img = np.random.default_rng(5).integers(0, 256, (61, 83), np.uint8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jenh.clahe(img, 3.0, 8, backend="pallas"))
    np.testing.assert_array_equal(tenh.clahe(_t(img)).numpy(), want)


def test_kernel_wrappers_refuse_other_devices_and_count_nothing_on_cpu():
    img = torch.zeros((3, 16, 16), dtype=torch.uint8)
    before = (tbil.bilateral_planar.launches, tclahe.clahe_hist.launches,
              tclahe.clahe_apply.launches)
    tbil.bilateral_planar(img)
    luts = tenh.clahe_luts_from_hist(tclahe.clahe_hist(img[0], 2, 2, 8), 4, 1)
    tclahe.clahe_apply(img[0], luts, 2, 2, 8)
    assert (tbil.bilateral_planar.launches, tclahe.clahe_hist.launches,
            tclahe.clahe_apply.launches) == before
    with pytest.raises(ValueError, match="expected CPU or CUDA"):
        tbil.bilateral_planar(img.to("meta"))
    with pytest.raises(ValueError, match="expected CPU or CUDA"):
        tclahe.clahe_hist(img[0].to("meta"), 2, 2, 8)


# ---------------------------------------------------------------------------
# The board warp and the whole enhancement
# ---------------------------------------------------------------------------


def test_warp_board_color_bit_equal(rng):
    """The tile-plan color warp and its one-gather assembly equal the JAX
    package's matmul warp with its static reassembly, bit for bit."""
    g = tgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    planar = np.ascontiguousarray(np.moveaxis(make_board_frame(initial_occupancy(), rng), -1, 0))
    qx, qy, starts, tile = g.board_tile_query_coords()
    jplan, jdims = jmr.build_plan(qx, qy, g.src_h, g.src_w)
    want = jax.jit(lambda f, p: jmr.warp_board_color(f, p, jdims, starts, g.board_size))(
        planar, jplan
    )
    plan, dims = tmr.build_plan(qx, qy, g.src_h, g.src_w)
    index = torch.as_tensor(tmr.board_tile_index(starts, tile, g.board_size))
    got = tmr.warp_board_color(_t(planar), plan, dims, index)
    assert got.shape == (3, g.board_size, g.board_size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _board(seed, px=120):
    """A noisy rendered top-down board, planar (3, px, px) u8."""
    occ = initial_occupancy()
    img = render_board(occ, px, np.random.default_rng(seed))
    return np.ascontiguousarray(np.moveaxis(np.clip(np.round(img), 0, 255), -1, 0)).astype(np.uint8)


# The whole enhancement: the bilateral's and Lab -> BGR's one-level
# differences pass through the sharpen (9x the center, -1x each neighbor),
# so a pixel may differ by more than one level; they stay rare (measured:
# 5 pixels of one board of four, by up to 9 levels).
ENHANCE_MAX_DIFF, ENHANCE_FRACTION = 9, 1e-3


@pytest.mark.parametrize("profile", [None, PROFILE], ids=["no_profile", "profile"])
def test_enhance_planar_vs_jax_with_pallas_kernels(monkeypatch, profile):
    """enhance_planar vs the JAX composition with its TPU kernels: the
    bilateral Pallas kernel and clahe(backend='pallas'), in interpret mode."""
    monkeypatch.setattr(jenh, "clahe", functools.partial(jenh.clahe, backend="pallas"))
    board = _board(3)
    fn = jax.jit(functools.partial(
        jenh_model.enhance_planar, profile=profile, bilateral_backend="pallas"
    ))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(board))
    got = tenh_model.enhance_planar(_t(board), profile).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= ENHANCE_MAX_DIFF and (d > 0).mean() <= ENHANCE_FRACTION, (
        d.max(), (d > 0).mean()
    )
    # The color profile stage alone is integer after convertScaleAbs up to
    # hsv2bgr's f32 step.
    if profile:
        assert_within_one_level(
            tenh_model.apply_color_profile(_t(board), profile).numpy(),
            np.asarray(jax.jit(lambda b: jenh_model.apply_color_profile(b, profile))(board)),
            what="apply_color_profile",
        )


def test_image_enhancer_api_on_the_cpu():
    """The reference-API class: HWC numpy in and out, each stage equal to its
    free function, and prepare_analysis equal to the JAX class's."""
    hwc = np.ascontiguousarray(np.moveaxis(_board(4, 96), 0, -1))
    enh = tenh_model.ImageEnhancer(profile=PROFILE, device="cpu")
    planar = _t(np.moveaxis(hwc, -1, 0))
    for got, want in (
        (enh.process_pipeline(hwc), tenh_model.enhance_planar(planar, PROFILE)),
        (enh.correct_lighting(hwc), tenh_model.correct_lighting(planar)),
        (enh.reduce_noise(hwc), tenh_model.bilateral(planar)),
        (enh.sharpen(hwc), tfilters.sharpen(planar)),
        (enh.normalize_intensity(hwc), tfilters.normalize_minmax(planar)),
        (enh.apply_color_profile(hwc), tenh_model.apply_color_profile(planar, PROFILE)),
    ):
        assert got.shape == hwc.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.moveaxis(want.numpy(), 0, -1))
    gray, binary = enh.prepare_analysis(hwc)
    jgray, jbinary = jenh_model.ImageEnhancerTPU().prepare_analysis(hwc)
    np.testing.assert_array_equal(gray, jgray)
    np.testing.assert_array_equal(binary, jbinary)
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tenh_model.ImageEnhancer()


def test_synth_camera_board_through_the_enhancer_keeps_its_shape():
    """The numpy renderer's board through the port's enhancement on the CPU:
    u8 of the same shape, the full range used (min-max normalize)."""
    cam = SynthCamera(DEFAULT_CORNERS)
    frame = cam.render(initial_occupancy(), np.random.default_rng(1))
    board = _t(np.moveaxis(frame[100:220, 400:520], -1, 0))
    out = tenh_model.enhance_planar(board)
    assert out.shape == board.shape and out.dtype == torch.uint8
    assert int(out.min()) == 0 and int(out.max()) == 255
