"""Pipeline parity: the port's VisionPipeline vs the JAX pipeline.

The scenario of tests/test_pipeline_e2e.py (reference capture, stable
frames, e2->e4, a hand-occlusion frame, forced full rescans) runs through
both packages on the same 1280x720 frames; every frame's StepOutputs must
agree: bool/i32 fields exactly, f32 fields within the tolerance below.
Both Hough backends are held: conv on planar and HWC frames, exact (the
port's ``auto`` on the CPU) on HWC frames of the gather route. The enhanced pipeline
(``with_enhancer=True``) is held against the JAX package's with its TPU
kernels (bilateral, CLAHE) in interpret mode.

Frame layouts: both packages pick the squares' route by layout, planar
frames the matmul resample and HWC frames the gather warp. Both host APIs
turn a host numpy HWC frame planar first (the JAX ``step`` for the TPU's
tile layout; the port does the same so that a host frame takes the same
route in both), and keep the layout of a device array: the gather route is
fed ``jnp.asarray`` on the JAX side and a tensor on the port's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chessboard_vision_tpu import geometry as geo
from chessboard_vision_tpu.models.pipeline import VisionPipeline as JaxPipeline
from chessboard_vision_tpu.ops import enhance as jax_enhance
from chessboard_vision_tpu_torch.models import pipeline as tp
from chessboard_vision_tpu_torch.models.pipeline import VisionPipeline as TorchPipeline
from chessboard_vision_tpu_torch.ops.layout import to_planar

from fixtures import DEFAULT_CORNERS, initial_occupancy, make_board_frame

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

# f32 outputs: confidence (symmetry) and profile_extent sum 4 ring values
# in another order than XLA, and XLA:CPU's sqrt/divide may differ from a
# correctly rounded one by an ulp (change_z_peak): a few ulps at most.
F32_RTOL, F32_ATOL = 1e-5, 1e-5
EXACT = ("occupancy", "raw_occupancy", "visual_changes", "method", "radius",
         "change_intensity")


def assert_outputs_match(t_out, j_out, where="", atol=None):
    """``atol`` maps a field name to its own absolute tolerance."""
    t_out = tp.outputs_to_numpy(t_out)
    for f in tp.StepOutputs._fields:
        t, j = getattr(t_out, f), np.asarray(getattr(j_out, f))
        assert t.dtype == j.dtype, f"{where} {f}: {t.dtype} vs {j.dtype}"
        if f in EXACT:
            np.testing.assert_array_equal(t, j, err_msg=f"{where} {f}")
        else:
            np.testing.assert_allclose(t, j, rtol=F32_RTOL, atol=(atol or {}).get(f, F32_ATOL),
                                       err_msg=f"{where} {f}")


def assert_states_match(t_state, j_state):
    t_state = tp.state_to_numpy(t_state)
    for part in ("piece", "change"):
        tn, jn = getattr(t_state, part), getattr(j_state, part)
        for f in tn._fields:
            t, j = getattr(tn, f), np.asarray(getattr(jn, f))
            assert t.dtype == j.dtype and t.shape == j.shape, f"{part}.{f}"
            if t.dtype == np.float32:
                np.testing.assert_allclose(t, j, rtol=F32_RTOL, atol=F32_ATOL, err_msg=f)
            else:
                np.testing.assert_array_equal(t, j, err_msg=f"{part}.{f}")


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(1234)
    occ0 = initial_occupancy()
    occ1 = occ0.copy()
    occ1[4, 1] = False
    occ1[4, 3] = True  # e2 -> e4
    frame0 = make_board_frame(occ0, rng)
    frames = [make_board_frame(occ0, rng) for _ in range(3)]
    frames += [make_board_frame(occ1, rng) for _ in range(6)]
    hand = make_board_frame(occ1, rng)
    hand[250:520, 450:800] = (120, 110, 100)
    frames.append(hand)
    frames += [make_board_frame(occ1, rng) for _ in range(6)]
    return frame0, frames


@pytest.fixture(scope="module")
def pipes():
    g = geo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    return (JaxPipeline(g, hough_backend="conv", donate_state=False),
            TorchPipeline(g, hough_backend="conv", device="cpu"))


ALL_SQUARES = {(f, r) for f in range(8) for r in range(8)}


def jax_frame(fr, layout="hwc"):
    """The frame the JAX pipeline is given for the rendered HWC frame ``fr``:
    "hwc" a device array (the gather warp), "host_hwc" the host array (taken
    planar), "planar" the planar host array."""
    if layout == "planar":
        return to_planar(fr)
    return fr if layout == "host_hwc" else jnp.asarray(fr)


def port_frame(fr, layout="hwc"):
    """The port's frame for the same route: "hwc" a tensor."""
    if layout == "planar":
        return to_planar(fr)
    return fr if layout == "host_hwc" else torch.as_tensor(fr)


def _run_sequence(jp, tpipe, clip, layout):
    frame0, frames = clip
    js = jp.capture_reference(jp.init_state(), jax_frame(frame0, layout))
    ts = tpipe.capture_reference(tpipe.init_state(), port_frame(frame0, layout))
    assert_states_match(ts, js)
    for i, fr in enumerate(frames):
        s2c = ALL_SQUARES if i > 10 else None
        js, jo = jp.step(js, jax_frame(fr, layout), squares_to_check=s2c)
        ts, to = tpipe.step(ts, port_frame(fr, layout), squares_to_check=s2c)
        assert_outputs_match(to, jo, where=f"frame {i}")
    assert_states_match(ts, js)
    return to


@pytest.mark.parametrize("layout", ["planar", "hwc", "host_hwc"])
def test_e2e_sequence_outputs_match_jax_every_frame(clip, pipes, layout):
    """The conv pipelines on planar frames (the matmul resample), on HWC
    device frames (the gather warp) and on HWC host frames (both packages
    take them planar)."""
    to = _run_sequence(*pipes, clip, layout)
    truth = initial_occupancy()
    truth[4, 1], truth[4, 3] = False, True
    assert tp.occupancy_to_set(to.occupancy) == {
        (f, r) for f in range(8) for r in range(8) if truth[f, r]
    }


def test_state_from_numpy_mid_sequence(clip, pipes):
    """Both packages start from the same mid-sequence JAX state (converted
    with state_from_numpy) and step once, with a forced re-reference and a
    smart-scan subset; the round trip through state_to_numpy is lossless."""
    frame0, frames = clip
    jp, tpipe = pipes
    js = jp.capture_reference(jp.init_state(), frame0)
    for fr in frames[:5]:
        js, _ = jp.step(js, fr)
    host = jax.tree.map(np.asarray, js)
    ts = tp.state_from_numpy(host, device="cpu")
    for a, b in zip(jax.tree.leaves(tp.state_to_numpy(ts)), jax.tree.leaves(host)):
        np.testing.assert_array_equal(a, b)
    s2c = {(4, 1), (4, 3), (0, 0)}
    js, jo = jp.step(js, jax_frame(frames[5]), squares_to_check=s2c, refresh_refs=True)
    ts, to = tpipe.step(ts, port_frame(frames[5]), squares_to_check=s2c, refresh_refs=True)
    assert_outputs_match(to, jo)
    assert_states_match(ts, js)


@pytest.mark.parametrize("layout", ["host_hwc", "hwc"])
def test_step_many_equals_sequential_steps(clip, pipes, layout):
    """step_many (one upload, a device loop, stacked outputs) equals K
    sequential step() calls exactly, outputs and state, with a forced
    re-reference on frame 0 and a smart-scan subset; on host HWC frames and
    on a tensor of them."""
    frame0, frames = clip
    _, tpipe = pipes
    chunk = [port_frame(fr, layout) for fr in frames[7:13]]
    s2c = {(4, 1), (4, 3)}
    seq = tpipe.capture_reference(tpipe.init_state(), frame0)
    many = tp.state_from_numpy(tp.state_to_numpy(seq), device="cpu")
    outs = []
    for i, fr in enumerate(chunk):
        seq, o = tpipe.step(seq, fr, squares_to_check=s2c, refresh_refs=i == 0)
        outs.append(tp.outputs_to_numpy(o))
    stack = torch.stack if layout == "hwc" else np.stack
    many, mo = tpipe.step_many(many, stack(chunk), squares_to_check=s2c, refresh_first=True)
    mo = tp.outputs_to_numpy(mo)
    for f in tp.StepOutputs._fields:
        np.testing.assert_array_equal(
            getattr(mo, f), np.stack([getattr(o, f) for o in outs]), err_msg=f
        )
    for a, b in zip(tp.state_to_numpy(seq), tp.state_to_numpy(many)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_outputs_to_numpy_dtypes_and_unsupported_options(pipes):
    _, tpipe = pipes
    out = tp.StepOutputs(*(
        torch.zeros(64, dtype=dt) for dt in (
            torch.bool, torch.bool, torch.bool, torch.int32, torch.float32, torch.int32,
            torch.int32, torch.float32, torch.float32, torch.float32, torch.float32,
            torch.float32,
        )
    ))
    out = out._replace(confidence=torch.full((64,), -1.5), radius=torch.arange(64, dtype=torch.int32))
    host = tp.outputs_to_numpy(out)
    assert host.confidence.dtype == np.float32 and (host.confidence == -1.5).all()
    np.testing.assert_array_equal(host.radius, np.arange(64))
    g = tpipe.geometry
    enhanced = TorchPipeline(g, with_enhancer=True, device="cpu")
    assert enhanced.with_enhancer and enhanced._tile_index.shape == (g.board_size,) * 2
    assert enhanced._tile_dims.q_rows == -(-g.board_size // 8)
    exact = TorchPipeline(g, device="cpu")  # auto: exact on the CPU, as the JAX package
    assert exact.hough_backend == "exact" and exact.consts.conv_plan is None
    assert exact.bounds.r_hi == int(exact.consts.params.max_radius.max())
    assert tpipe.consts.params is None and tpipe.bounds is None
    with pytest.raises(ValueError, match="hough_backend"):
        TorchPipeline(g, hough_backend="scatter", device="cpu")
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TorchPipeline(g)


def test_state_from_numpy_defaults_to_the_card(pipes):
    """state_from_numpy takes the entry points' default, the card: without
    one it raises instead of building the state on the CPU in silence."""
    _, tpipe = pipes
    host = tp.state_to_numpy(tpipe.init_state())
    on_cpu = tp.state_from_numpy(host, device="cpu")
    assert all(t.device.type == "cpu" for part in on_cpu for t in part)
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for part in tp.state_from_numpy(host) for t in part)
    else:
        with pytest.raises(RuntimeError, match="state_from_numpy.*device='cpu'"):
            tp.state_from_numpy(host)


# The enhanced squares' gray differs from the JAX package's on a few pixels
# (the bilateral's and Lab -> BGR's one-level differences, sharpened): the
# per-square means over ~1,000-pixel regions move by up to this much.
ENHANCED_MEAN_ATOL = 0.05


def test_enhanced_pipeline_matches_jax_with_pallas_kernels(clip, pipes, monkeypatch):
    """with_enhancer=True vs the JAX enhanced pipeline with its TPU kernels
    in interpret mode (bilateral_backend='pallas', clahe switched to
    backend='pallas'): reference capture, a stable frame, then e2->e4 with a
    forced full scan. bool/i32 outputs exact on every frame."""
    to = _enhanced_vs_jax(clip, pipes[1].geometry, "conv", monkeypatch)
    truth = initial_occupancy()
    truth[4, 1], truth[4, 3] = False, True
    # The fresh detection shows the move (the smoothed occupancy lags it).
    assert tp.occupancy_to_set(to.raw_occupancy) == {
        (f, r) for f in range(8) for r in range(8) if truth[f, r]
    }


def _enhanced_vs_jax(clip, g, backend, monkeypatch):
    """Enhanced pipelines of one Hough backend on HWC device frames (the
    board from the gather warp): reference capture, a stable frame, then e2->e4 with a
    forced full scan; outputs compared on each frame."""
    frame0, frames = clip
    monkeypatch.setattr(jax_enhance, "clahe", functools.partial(jax_enhance.clahe, backend="pallas"))
    tpipe = TorchPipeline(g, with_enhancer=True, hough_backend=backend, device="cpu")
    atol = {"center_mean": ENHANCED_MEAN_ATOL, "corner_mean": ENHANCED_MEAN_ATOL}
    with pltpu.force_tpu_interpret_mode():
        jp = JaxPipeline(g, hough_backend=backend, with_enhancer=True,
                         bilateral_backend="pallas", donate_state=False)
        js = jp.capture_reference(jp.init_state(), jax_frame(frame0))
        ts = tpipe.capture_reference(tpipe.init_state(), port_frame(frame0))
        for i, s2c in ((0, None), (4, ALL_SQUARES)):
            js, jo = jp.step(js, jax_frame(frames[i]), squares_to_check=s2c)
            ts, to = tpipe.step(ts, port_frame(frames[i]), squares_to_check=s2c)
            assert_outputs_match(to, jo, where=f"{backend} enhanced frame {i}", atol=atol)
    return to


def test_exact_pipeline_matches_jax_on_hwc_frames_every_frame(clip, pipes):
    """hough_backend="exact" (the port's auto on the CPU) on HWC device
    frames (the gather warp) against the jitted JAX exact pipeline on every frame of the
    sequence; the last frame shows the move."""
    g = pipes[1].geometry
    to = _run_sequence(JaxPipeline(g, hough_backend="exact", donate_state=False),
                       TorchPipeline(g, device="cpu"), clip, "hwc")
    truth = initial_occupancy()
    truth[4, 1], truth[4, 3] = False, True
    assert tp.occupancy_to_set(to.occupancy) == {
        (f, r) for f in range(8) for r in range(8) if truth[f, r]
    }


def test_exact_enhanced_pipeline_matches_jax_on_hwc_frames(clip, pipes, monkeypatch):
    """The enhanced exact pipeline on HWC device frames vs the JAX package's with
    its TPU kernels in interpret mode."""
    to = _enhanced_vs_jax(clip, pipes[1].geometry, "exact", monkeypatch)
    truth = initial_occupancy()
    truth[4, 1], truth[4, 3] = False, True
    # The fresh detection shows the move (the smoothed occupancy lags it).
    assert tp.occupancy_to_set(to.raw_occupancy) == {
        (f, r) for f in range(8) for r in range(8) if truth[f, r]
    }
