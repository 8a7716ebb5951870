"""The port's cv2-free corner detector and grid refinement vs the JAX package.

The contour stages (contours.py, numpy on the host) are each held against
the cv2 call they replace on seeded inputs: external border following
(cv2.findContours RETR_EXTERNAL, CHAIN_APPROX_NONE), the shoelace area, the
closed arc length and Douglas-Peucker for a closed curve, all exactly
equal. ``geometry.find_chessboard_corners`` (its image stages in torch on
the CPU here) returns the JAX function's integer corners exactly on
straight, bumped, tilted and rotated boards, the lens and hard renderers,
SynthCamera frames, and busy frames where both return nothing.
``refine_grid`` returns the JAX function's lines on warped boards. A long
weak Canny chain shows why the detector lifts the hysteresis cap.
"""

import cv2
import numpy as np
import pytest
import torch

from chessboard_vision_tpu import geometry as jgeo
from chessboard_vision_tpu_torch import contours as tc
from chessboard_vision_tpu_torch import geometry as tgeo
from chessboard_vision_tpu_torch.ops.canny import canny
from chessboard_vision_tpu_torch.tools.synth import SynthCamera

from fixtures import (
    DEFAULT_CORNERS,
    add_hand_sprite,
    apply_barrel,
    initial_occupancy,
    make_board_frame,
    make_hard_board_frame,
)

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)


def _blobs(rng, h=90, w=120):
    """A binary image of filled polygons and ellipses, some touching the
    image's frame, with speckle; dilated on odd draws."""
    m = np.zeros((h, w), np.uint8)
    for _ in range(rng.integers(1, 5)):
        if rng.random() < 0.5:
            n = rng.integers(3, 8)
            c, r = rng.uniform(0, w, 2), rng.uniform(8, 40)
            t = np.sort(rng.uniform(0, 2 * np.pi, n))
            p = np.stack([c[0] + r * np.cos(t), c[1] * h / w + r * np.sin(t)], -1)
            cv2.fillPoly(m, [p.astype(np.int32)], 1)
        else:
            cv2.ellipse(m, (int(rng.uniform(0, w)), int(rng.uniform(0, h))),
                        (int(rng.uniform(3, 30)), int(rng.uniform(3, 30))),
                        float(rng.uniform(0, 180)), 0, 360, 1, -1)
    m |= (rng.random((h, w)) < 0.02).astype(np.uint8)
    if rng.random() < 0.5:
        m = cv2.dilate(m, np.ones((3, 3), np.uint8))
    return m


def _cv2_external(mask):
    return cv2.findContours(mask.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)[0]


@pytest.mark.parametrize("seed", range(4))
def test_external_contours_equal_cv2(seed):
    """Random blob images (speckle, blobs touching the frame, rings around
    other blobs): the same contours, point for point, in cv2's order."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        mask = _blobs(rng)
        got, want = tc.find_external_contours(mask), _cv2_external(mask)
        assert [c.tolist() for c in got] == [c.tolist() for c in want]
        assert all(c.dtype == np.int32 and c.shape[1:] == (1, 2) for c in got)


def test_external_contours_frame_start_nesting_and_pruning():
    """cv2 5's behaviours the detector relies on: a blob at (0, 0) keeps the
    image's frame and starts its contour there; each border starts at its
    raster-first pixel and walks down first; a blob inside another's hole
    is dropped; min_box_area skips the components that cannot pass."""
    mask = np.zeros((40, 60), np.uint8)
    mask[0:5, 0:6] = 1  # at the frame
    mask[10:30, 20:50] = 1  # a ring ...
    mask[13:27, 23:47] = 0
    mask[17:22, 30:36] = 1  # ... with a blob in its hole
    mask[30:33, 2:4] = 1
    got, want = tc.find_external_contours(mask), _cv2_external(mask)
    assert [c.tolist() for c in got] == [c.tolist() for c in want]
    assert len(got) == 3  # the nested blob is dropped
    starts = {tuple(c[0, 0]) for c in got}
    assert starts == {(0, 0), (20, 10), (2, 30)}
    ring = next(c for c in got if tuple(c[0, 0]) == (20, 10))
    assert tuple(ring[1, 0]) == (20, 11)  # down first
    big = tc.find_external_contours(mask, min_box_area=29 * 19 - 1)
    assert [c.tolist() for c in big] == [ring.tolist()]
    assert tc.find_external_contours(mask, min_box_area=29 * 19) == []


def _curves(rng):
    """Closed point sequences: noisy ellipses, random polygons, and real
    contours with their pixel steps and revisits."""
    out = []
    for _ in range(60):
        n = int(rng.integers(3, 60))
        t = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(10, 300)
        p = np.stack([400 + r * np.cos(t) + rng.normal(0, 3, n),
                      300 + r * rng.uniform(0.3, 1) * np.sin(t)], -1)
        out.append(np.round(p).astype(np.int32).reshape(-1, 1, 2))
        out.append(rng.integers(0, 50, (int(rng.integers(3, 9)), 1, 2)).astype(np.int32))
    for _ in range(20):
        out += list(_cv2_external(_blobs(rng)))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_area_length_and_approx_equal_cv2(seed):
    """contourArea, arcLength(closed) and approxPolyDP(closed) at several
    epsilons: exactly cv2's numbers and vertices."""
    rng = np.random.default_rng(10 + seed)
    for c in _curves(rng):
        assert tc.contour_area(c) == cv2.contourArea(c)
        length = tc.arc_length(c)
        assert length == cv2.arcLength(c, True)
        for eps in (0.5, 0.01 * length, 0.02 * length, 0.1 * length):
            np.testing.assert_array_equal(tc.approx_poly_dp(c, eps),
                                          cv2.approxPolyDP(c, eps, True))


def _rotated(corners, deg, scale=1.0, shift=(0, 0)):
    c = np.asarray(corners, np.float64) * scale + shift
    ctr, t = c.mean(0), np.deg2rad(deg)
    rot = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
    return (c - ctr) @ rot.T + ctr


def _clutter(rng):
    frame = np.full((720, 1280, 3), 90, np.uint8)
    for _ in range(300):
        x, y = rng.integers(0, 1280), rng.integers(0, 720)
        cv2.rectangle(frame, (int(x), int(y)), (int(x + rng.integers(5, 60)),
                                                int(y + rng.integers(5, 60))),
                      tuple(int(v) for v in rng.integers(0, 255, 3)), -1)
    return frame


FRAMES = {
    "straight": lambda rng, occ: make_board_frame(occ, rng),
    "bumped": lambda rng, occ: make_board_frame(occ, rng, corners=DEFAULT_CORNERS + [12, 7]),
    "tilted": lambda rng, occ: make_board_frame(
        occ, rng, corners=np.array([[300, 60], [980, 120], [200, 660], [1100, 640]])),
    "rotated_10": lambda rng, occ: make_board_frame(occ, rng,
                                                    corners=_rotated(DEFAULT_CORNERS, 10)),
    "rotated_40": lambda rng, occ: make_board_frame(
        occ, rng, corners=_rotated(DEFAULT_CORNERS, 40, 0.8, (130, 70))),
    "rotated_out_of_frame": lambda rng, occ: make_board_frame(
        occ, rng, corners=_rotated(DEFAULT_CORNERS, -25)),
    "lens": lambda rng, occ: apply_barrel(make_board_frame(occ, rng)),
    "hard": lambda rng, occ: make_hard_board_frame(occ, rng, t=1.3),
    "hard_tilted": lambda rng, occ: make_hard_board_frame(
        occ, rng, corners=_rotated(DEFAULT_CORNERS, -8), t=0.4),
    "synth": lambda rng, occ: SynthCamera(DEFAULT_CORNERS).render(occ, rng),
    "synth_rotated": lambda rng, occ: SynthCamera(_rotated(DEFAULT_CORNERS, 15, 0.9)).render(
        occ, rng),
    "hand": lambda rng, occ: add_hand_sprite(make_board_frame(occ, rng), rng),
    "clutter": lambda rng, occ: _clutter(rng),
}
EMPTY = {"rotated_out_of_frame", "hand", "clutter"}


@pytest.mark.parametrize("name", list(FRAMES))
def test_find_chessboard_corners_equals_jax(name):
    """The JAX function's integer corners exactly, or empty where it finds
    no board (the board cut by the frame, a hand over it, a busy scene)."""
    rng = np.random.default_rng(sorted(FRAMES).index(name))
    frame = FRAMES[name](rng, initial_occupancy())
    want = jgeo.find_chessboard_corners(frame)
    got = tgeo.find_chessboard_corners(frame, device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got.size == 0) == (name in EMPTY)


def test_board_edge_mask_equals_cv2():
    """The image stages alone: gray, GaussianBlur(7, 1), Canny(30, 100) and
    dilate(5x5, 3 iterations), bit-equal to cv2 on a board frame."""
    frame = make_hard_board_frame(initial_occupancy(), np.random.default_rng(7), t=2.0)
    g = cv2.GaussianBlur(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY), (7, 7), 1)
    want = cv2.dilate(cv2.Canny(g, 30, 100), np.ones((5, 5), np.uint8), iterations=3) > 0
    np.testing.assert_array_equal(tgeo.board_edge_mask(frame, device="cpu").numpy(), want)


def test_long_weak_chain_needs_the_frame_sized_cap():
    """A 600 px low-contrast edge that touches one strong edge: cv2.Canny
    (no cap) keeps all of it, as the port's Canny does with the detector's
    H * W cap; the Hough path's 256-dilation cap stops part of the way."""
    img = np.full((240, 720), 100, np.uint8)
    img[120:, 60:660] += 10  # weak: |grad| 40, between the thresholds
    img[120:, 60:80] += 30  # strong: |grad| 160
    want = cv2.Canny(img, 30, 100) > 0
    x = torch.from_numpy(img)
    np.testing.assert_array_equal(canny(x, 30, 100, max_iters=240 * 720).numpy(), want)
    capped = canny(x, 30, 100).numpy()
    assert capped.sum() < want.sum() and not (capped & ~want).any()


@pytest.mark.parametrize("corners", [DEFAULT_CORNERS, DEFAULT_CORNERS + [12, 7],
                                     _rotated(DEFAULT_CORNERS, 6)], ids=["default", "bumped",
                                                                         "rotated"])
def test_refine_grid_equals_jax(corners):
    """Grid lines from the Canny projections of a warped board equal the JAX
    function's (cv2) on boards warped from their frames."""
    rng = np.random.default_rng(3)
    frame = make_board_frame(initial_occupancy(), rng, corners=np.asarray(corners))
    g = jgeo.BoardGeometry.from_calibration(DEFAULT_CORNERS)
    warped = cv2.warpPerspective(frame, g.matrix, (g.board_size, g.board_size))
    assert tgeo.refine_grid(warped, device="cpu") == jgeo.refine_grid(warped)
