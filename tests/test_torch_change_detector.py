"""ChangeDetectorModel (models/change_detector.py) vs the JAX class, on the CPU.

The same (64, H, W) u8 squares, made from a seed with numpy, go through
both models method for method: detect before calibration, calibrate,
detect with and without focus squares, the reference update, the hand
pattern. Squares, intensity classes and hand decisions must be equal.
The JAX class runs its ops eagerly (no jit), so its EMA update rounds each
product and sum on its own, where the port's update rounds as the jitted
step does (fused multiply-adds, ROADMAP Queue C 1): the means are compared
within one f32 ulp, the variances within what one ulp of the mean moves
them (below), and z-scores within Z_RTOL (XLA:CPU's sqrt and divide,
ROADMAP Queue C 2).
"""

import numpy as np
import pytest
import torch

from chessboard_vision_tpu.models.change_detector import ChangeDetectorModel as JaxModel
from chessboard_vision_tpu_torch.models.change_detector import ChangeDetectorModel as TorchModel

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

MEAN_RTOL = 1.2e-7  # one f32 ulp
# new_var = (1 - a) v + a (x - new_mean)^2: a mean one ulp apart (<= 2^-16
# below 256) moves the second term by up to 2 a |x - m| ulp = 7.8e-4 at
# a = 0.1, |x - m| <= 255 (measured: 2.1e-4).
VAR_ATOL = 1e-3
Z_RTOL = 1e-6


def _squares(shape, seed):
    """A background, a frame with a hand-like block of changes over 5
    squares and a move over 2, each with sensor noise."""
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 200, shape[0])[:, None, None] + np.zeros(shape)

    def noisy(img):
        return np.clip(img + rng.normal(0, 3, shape), 0, 255).astype(np.uint8)

    move = base.copy()
    move[12] += 60  # e2: the piece leaves
    move[28, : shape[1] // 2] -= 50  # e4: half the square changes
    hand = move.copy()
    hand[[3, 4, 5, 11, 19]] += 90
    return noisy(base), noisy(move), noisy(hand)


def _compare_detailed(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k]["intensity"] == want[k]["intensity"], k
        assert got[k]["pct_changed"] == want[k]["pct_changed"], k
        np.testing.assert_allclose(got[k]["z_score"], want[k]["z_score"], rtol=Z_RTOL)


@pytest.mark.parametrize("variable_squares", [False, True], ids=["uniform", "variable_size"])
def test_change_detector_model_matches_jax(variable_squares):
    shape = (64, 24, 24)
    kw = {}
    if variable_squares:  # squares of 20..24 px sides: a mask and true counts
        rng = np.random.default_rng(7)
        h, w = rng.integers(20, 25, 64), rng.integers(20, 25, 64)
        yy, xx = np.mgrid[: shape[1], : shape[2]]
        kw = dict(valid_mask=(yy[None] < h[:, None, None]) & (xx[None] < w[:, None, None]),
                  counts=(h * w).astype(np.int32))
    bg, move, hand = _squares(shape, 3)
    j, t = JaxModel(shape=shape, **kw), TorchModel(shape=shape, device="cpu", **kw)
    assert t.detect_changes_detailed(move) == j.detect_changes_detailed(move) == {}

    t.update_all_references(bg)  # uncalibrated: calibrates
    j.update_all_references(bg)
    assert t.is_calibrated and j.is_calibrated
    for frame in (move, hand):
        got, want = t.detect_changes_detailed(frame), j.detect_changes_detailed(frame)
        _compare_detailed(got, want)
        assert t.detect_changes(frame) == j.detect_changes(frame)
        assert t.classify_hand_pattern(got) == j.classify_hand_pattern(want)
    assert {(4, 1), (4, 3)} <= set(t.detect_changes_detailed(move))
    assert t.classify_hand_pattern(t.detect_changes_detailed(move))["is_move"]
    assert t.classify_hand_pattern(t.detect_changes_detailed(hand))["is_hand"]

    focus = {(4, 1), (3, 0), (7, 7)}
    for m in (t, j):
        m.set_focus_squares(focus)
    assert t.get_focus_count() == j.get_focus_count() == 3
    _compare_detailed(t.detect_changes_detailed(hand), j.detect_changes_detailed(hand))
    for m in (t, j):  # the EMA update on the focus squares alone
        m.update_all_references(move)
    np.testing.assert_allclose(t.state.means.numpy(), np.asarray(j.state.means), rtol=MEAN_RTOL)
    np.testing.assert_allclose(t.state.variances.numpy(), np.asarray(j.state.variances),
                               rtol=0, atol=VAR_ATOL)
    np.testing.assert_array_equal(t.state.calibrated.numpy(), np.asarray(j.state.calibrated))
    for m in (t, j):
        m.clear_focus()
    assert t.get_focus_count() == j.get_focus_count() == 64
    _compare_detailed(t.detect_changes_detailed(move), j.detect_changes_detailed(move))


def test_change_detector_model_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchModel()
