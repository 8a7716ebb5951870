"""The port's plan builders produce the JAX package's plans, array for array.

The system has no learned weights: its parameters are these calibration
plans (and the temporal state, covered in test_torch_pipeline.py). Each
plan is built from the same BoardGeometry by both packages and compared
exactly, bf16 basis included.
"""

import numpy as np
import pytest
import torch

from chessboard_vision_tpu import geometry as geo
from chessboard_vision_tpu.ops import hough_conv as jhc
from chessboard_vision_tpu.ops import matmul_resample as jmr
from chessboard_vision_tpu.ops import piece as jpiece
from chessboard_vision_tpu.ops import warp as jwarp
from chessboard_vision_tpu_torch.ops import hough_conv as thc
from chessboard_vision_tpu_torch.ops import matmul_resample as tmr
from chessboard_vision_tpu_torch.ops import piece as tpiece
from chessboard_vision_tpu_torch.ops import warp as twarp
from chessboard_vision_tpu_torch.tools.demo_pipeline import CORNERS as DEMO_CORNERS
from chessboard_vision_tpu_torch.tools.synth import bench_corners

from fixtures import DEFAULT_CORNERS

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

GEOMETRIES = {
    "fixture": dict(corners=DEFAULT_CORNERS),
    "demo": dict(corners=np.array(DEMO_CORNERS)),
    "bench_layout": dict(corners=bench_corners(720, 1280)),
    "strong_skew": dict(corners=np.array([[300, 60], [980, 140], [200, 690], [1100, 600]])),
    "flipped": dict(corners=DEFAULT_CORNERS, orientation_flipped=True),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _assert_fields_equal(tplan, jplan, fields):
    for f in fields:
        t, j = _np(getattr(tplan, f)), _np(getattr(jplan, f))
        assert t.dtype == j.dtype, f"{f}: {t.dtype} vs {j.dtype}"
        np.testing.assert_array_equal(t, j, err_msg=f)


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def geometry(request):
    return geo.BoardGeometry.from_calibration(**GEOMETRIES[request.param])


def test_matmul_resample_plan_equal(geometry):
    g = geometry
    qx, qy = g.square_query_coords()
    jplan, jdims = jmr.build_plan(qx, qy, g.src_h, g.src_w)
    tplan, tdims = tmr.build_plan(qx, qy, g.src_h, g.src_w, device="cpu")
    assert tuple(tdims) == tuple(jdims)
    common = [f for f in tplan._fields if f in jplan._fields]
    assert len(common) == 8
    _assert_fields_equal(tplan, jplan, common)
    # The lerp weights the JAX plan precomputes are the port's 1 - fx / fx.
    hw0 = np.asarray(jplan.hw[0])[:, : jdims.q_rows]
    w = np.where(_np(tplan.ux_off) == 0, 1.0 - _np(tplan.fx), np.float32(0))
    np.testing.assert_array_equal(hw0, w.astype(np.float32))


def test_conv_hough_plan_equal(geometry):
    s = geometry.squares
    kw = dict(plane_h=int(s.heights.max()), plane_w=int(s.widths.max()), hysteresis_rounds=2)
    jplan, jdims = jhc.ConvHoughPlan.build(s.heights, s.widths, **kw)
    tplan, tdims = thc.ConvHoughPlan.build(s.heights, s.widths, device="cpu", **kw)
    assert tdims == jdims
    assert tplan._fields == jplan._fields
    assert tplan.basis.dtype == torch.bfloat16
    _assert_fields_equal(tplan, jplan, tplan._fields)


def test_piece_masks_and_device_geometry_equal(geometry):
    s = geometry.squares
    H, W = int(s.heights.max()), int(s.widths.max())
    jm = jpiece.PieceMasks.build(s.heights, s.widths, H, W)
    tm = tpiece.PieceMasks.build(s.heights, s.widths, H, W, device="cpu")
    assert tm._fields == jm._fields
    _assert_fields_equal(tm, jm, tm._fields)
    jdg = jwarp.DeviceGeometry.from_host(geometry)
    tdg = twarp.DeviceGeometry.from_host(geometry, device="cpu")
    _assert_fields_equal(tdg, jdg, tdg._fields)
