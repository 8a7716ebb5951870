"""The work counts and bounds of the Hough score matmul (B1)."""

import pytest

from benchmark.roofline import b1_bound, b1_shape, bound


def test_b1_at_the_hall_shape():
    m, n, k = b1_shape((1080, 1920), 8)
    assert (m, n, k) == (7095, 512, 3200)  # 7168 rows as the plan pads them
    t, which = b1_bound(m, n, k)
    assert which == "operations"
    assert t == pytest.approx(2 * 7095 * 512 * 3200 / 989e12)
    assert round(t * 1e6, 1) == 23.5  # us, by operations, at N = 512


def test_b1_at_the_player_shape():
    m, n, k = b1_shape((720, 1280), 1)
    assert (m, n, k) == (1850, 64, 2 * 25 * 25)  # 2048 rows as the plan pads them
    t, which = b1_bound(m, n, k)
    assert which == "bytes"
    assert t == pytest.approx((2 * m * k + 2 * n * k + 4 * m * n) / 3.35e12)


def test_bound_takes_the_larger():
    assert bound(3.35e12, 1.0, 1e12) == (1.0, "bytes")
    assert bound(1.0, 2e12, 1e12) == (2.0, "operations")
