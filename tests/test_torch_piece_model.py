"""PieceDetectorModel and the warp module's masked helpers, against the
JAX package on the CPU.

The model (the reference PieceDetector's host API over the device state,
exact Hough backend) is driven through all four methods on preprocessed
squares of tests/fleet_fixture.py's 320x240 rig (a start position, e2
lifted, e2e4), with and without squares_to_check, in both packages:
every DetectAllOutputs field and the final state must agree (bool/i32
exactly, f32 within tests/test_torch_pipeline.py's tolerance), and the
occupied sets exactly. ``masked_std``, ``interior`` and
``DeviceGeometry.pad`` are held to the JAX functions on seeded inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessboard_vision_tpu.models import PieceDetectorModel as JaxModel
from chessboard_vision_tpu.ops import warp as jwarp
from chessboard_vision_tpu_torch.models import PieceDetectorModel
from chessboard_vision_tpu_torch.models import pipeline as tp
from chessboard_vision_tpu_torch.ops import warp as twarp

from fixtures import initial_occupancy
from test_torch_mesh import _frames, _geos
from test_torch_pipeline import F32_ATOL, F32_RTOL

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

SETTINGS = {"min_radius": 22, "max_radius": 50}


def _squares(seed):
    """Preprocessed (64, H, W) u8 squares of three positions."""
    _, tg = _geos()
    pipe = tp.VisionPipeline(tg, hough_backend="exact", device="cpu")
    start = initial_occupancy()
    lifted, moved = start.copy(), start.copy()
    lifted[4, 1] = False
    moved[4, 1], moved[4, 3] = False, True
    frames = _frames(np.random.default_rng(seed), [start, start, lifted, moved, moved])
    return tg, [pipe.preprocess(torch.as_tensor(f))[0].numpy() for f in frames]


def _assert_close(t, j, what):
    t, j = np.asarray(t), np.asarray(j)
    assert t.dtype == j.dtype and t.shape == j.shape, what
    if t.dtype == np.float32:
        np.testing.assert_allclose(t, j, rtol=F32_RTOL, atol=F32_ATOL, err_msg=what)
    else:
        np.testing.assert_array_equal(t, j, err_msg=what)


@pytest.mark.parametrize("settings", [None, SETTINGS])
def test_piece_detector_model_matches_jax(settings):
    tg, grays = _squares(71)
    s = tg.squares
    jm = JaxModel(s.heights, s.widths, settings)
    tm = PieceDetectorModel(s.heights, s.widths, settings, device="cpu")
    assert tm.device == torch.device("cpu")
    jm.calibrate_reference(grays[0])
    tm.calibrate_reference(grays[0])
    calls = [
        ("get_occupied_squares", (grays[1],), {}),
        ("detect_all_pieces", (grays[2],), {}),
        ("detect_all_pieces", (grays[3],), {"squares_to_check": {(4, 1), (4, 3)}}),
        ("update_references", (grays[3],), {}),
        ("detect_all_pieces", (grays[4],), {"squares_to_check": {(4, 3), (0, 0)},
                                             "use_smoothing": False, "use_delta": False}),
        ("get_occupied_squares", (grays[4],), {"use_smoothing": False}),
    ]
    for i, (method, args, kw) in enumerate(calls):
        got, want = getattr(tm, method)(*args, **kw), getattr(jm, method)(*args, **kw)
        if method == "get_occupied_squares":
            assert got == want, i
        elif method == "detect_all_pieces":
            for f in want._fields:
                _assert_close(getattr(got, f).numpy(), getattr(want, f), f"call {i} {f}")
    for f in jm.state._fields:
        _assert_close(getattr(tm.state, f).numpy(), getattr(jm.state, f), f"state {f}")
    last = tm.get_occupied_squares(grays[4])
    assert (4, 3) in last and (4, 1) not in last


def test_masked_std_interior_and_pad_match_jax():
    tg, grays = _squares(72)
    jg, _ = _geos()
    jdg, tdg = jwarp.DeviceGeometry.from_host(jg), twarp.DeviceGeometry.from_host(tg, device="cpu")
    assert tdg.pad == jdg.pad == tg.squares.pad
    x = np.random.default_rng(73).integers(0, 256, tuple(tdg.sq_iy.shape), np.uint8)
    np.testing.assert_array_equal(twarp.interior(torch.as_tensor(x), tdg).numpy(),
                                  np.asarray(jwarp.interior(jnp.asarray(x), jdg)))
    xc = np.random.default_rng(74).integers(0, 256, tuple(tdg.sq_iy.shape) + (3,), np.uint8)
    np.testing.assert_array_equal(twarp.interior(torch.as_tensor(xc), tdg).numpy(),
                                  np.asarray(jwarp.interior(jnp.asarray(xc), jdg)))
    got = twarp.masked_std(torch.as_tensor(grays[1]), tdg.sq_mask, tdg.sq_counts).numpy()
    want = np.asarray(jwarp.masked_std(jnp.asarray(grays[1]), jdg.sq_mask, jdg.sq_counts))
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)
