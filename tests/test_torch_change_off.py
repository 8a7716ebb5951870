"""``with_change_detector=False`` on the port against the JAX package.

The EMA change model left out of the step: its state passes through
unchanged and change_intensity / change_pct / change_z_peak are zeros of
the JAX package's dtypes (i32, f32, f32); nothing else in the step
changes. Single-stream on tests/fleet_fixture.py's 320x240 rig, and 8
streams unmeshed and on the 4 x 2 mesh (8 CPU slots against 8 forced CPU
devices), each against the JAX pipeline of the same kind on the same
frames: bool/i32 exactly, f32 within tests/test_torch_pipeline.py's
tolerance, and the states likewise.
"""

import numpy as np
import pytest
import torch

from chessboard_vision_tpu.models.pipeline import VisionPipeline as JaxPipeline
from chessboard_vision_tpu.parallel import make_mesh as jax_make_mesh
from chessboard_vision_tpu.parallel.multistream import MultiStreamPipeline as JaxMulti
from chessboard_vision_tpu_torch.models import pipeline as tp
from chessboard_vision_tpu_torch.parallel import make_mesh
from chessboard_vision_tpu_torch.parallel import multistream as tms

from fixtures import initial_occupancy
from test_torch_mesh import _frames, _geos, _moved, _run, _sequence
from test_torch_multistream import assert_multi_match, assert_multi_states_match
from test_torch_pipeline import assert_outputs_match, assert_states_match

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

CHANGE_FIELDS = {"change_intensity": np.int32, "change_pct": np.float32,
                 "change_z_peak": np.float32}


def _assert_change_off(host_step):
    for f, dtype in CHANGE_FIELDS.items():
        x = getattr(host_step, f)
        assert x.dtype == dtype and not x.any(), f


def test_single_stream_without_change_detector_matches_jax():
    jg, tg = _geos()
    jp = JaxPipeline(jg, hough_backend="conv", with_change_detector=False, donate_state=False)
    p = tp.VisionPipeline(tg, hough_backend="conv", with_change_detector=False, device="cpu")
    rng = np.random.default_rng(51)
    ref = _frames(rng, [initial_occupancy()])[0]
    frames = _frames(rng, [initial_occupancy(), _moved(4), _moved(4)])
    js = jp.capture_reference(jp.init_state(), ref)
    ts = p.capture_reference(p.init_state(), ref)
    captured = tp.state_to_numpy(ts).change
    for i, fr in enumerate(frames):
        s2c = {(4, 1), (4, 3)} if i == 2 else None
        js, jo = jp.step(js, fr, squares_to_check=s2c, refresh_refs=i == 1)
        ts, to = p.step(ts, fr, squares_to_check=s2c, refresh_refs=i == 1)
        assert_outputs_match(to, jo, where=f"frame {i}")
        _assert_change_off(tp.outputs_to_numpy(to))
    assert_states_match(ts, js)
    for a, b in zip(tp.state_to_numpy(ts).change, captured):
        np.testing.assert_array_equal(a, b)  # the change state passed through


@pytest.mark.parametrize("meshed", [False, True])
def test_eight_streams_without_change_detector_match_jax(meshed):
    jg, tg = _geos()
    kw = dict(hough_backend="conv", with_change_detector=False)
    if meshed:
        jm = JaxMulti(jg, n_streams=8, mesh=jax_make_mesh(8, ("data", "space"), (4, 2)), **kw)
        tm = tms.MultiStreamPipeline(tg, 8, mesh=make_mesh(8, ("data", "space"), (4, 2),
                                                           devices=["cpu"] * 8), **kw)
    else:
        jm = JaxMulti(jg, n_streams=8, **kw)
        tm = tms.MultiStreamPipeline(tg, 8, device="cpu", **kw)
    ref, ticks = _sequence(52, 8)
    js, jouts = _run(jm, ref, ticks)
    ts, touts = _run(tm, ref, ticks)
    for t, (to, jo) in enumerate(zip(touts, jouts)):
        assert_multi_match(to, jo, where=f"tick {t}")
        _assert_change_off(tms.outputs_to_numpy(to).step)
    assert_multi_states_match(ts, js)
