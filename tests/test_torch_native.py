"""The port's frame ring (native/, built from its own copy of the C++ source
with g++ at first use): the FrameRing cases of tests/test_native.py (FIFO,
drop-oldest, skip-to-latest, a threaded producer), each checked against the
JAX package's ring on the same pushes, and what the port adds: a failed
build raises instead of degrading, and bad frames or a closed ring raise.
"""

import sys
import threading

import numpy as np
import pytest

from chessboard_vision_tpu import native as jnative
from chessboard_vision_tpu_torch import native


def _both(shape, n_slots):
    rings = [native.FrameRing(shape, n_slots=n_slots)]
    if jnative.AVAILABLE:  # the JAX binding degrades when its build fails
        rings.append(jnative.FrameRing(shape, n_slots=n_slots))
    return rings


def test_push_pop_fifo():
    frames = [np.full((4, 4), i, np.uint8) for i in range(3)]
    for ring in _both((4, 4), 4):
        for f in frames:
            ring.push(f)
        assert len(ring) == 3
        for i in range(3):
            seq, out = ring.pop()
            assert seq == i + 1
            assert np.array_equal(out, frames[i])
        assert ring.pop() == (0, None)
        ring.close()


def test_drop_oldest_when_full():
    for ring in _both((2, 2), 2):
        for i in range(5):
            ring.push(np.full((2, 2), i, np.uint8))
        assert len(ring) == 2
        seq, out = ring.pop()
        assert out[0, 0] == 3 and seq == 4  # the oldest surviving
        assert ring.dropped == 3  # counted by the consumer
        seq, out = ring.pop()
        assert out[0, 0] == 4 and seq == 5
        assert ring.pop() == (0, None)
        ring.close()


def test_skip_to_latest():
    for ring in _both((2, 2), 8):
        for i in range(5):
            ring.push(np.full((2, 2), i, np.uint8))
        assert ring.skip_to_latest() == 4
        seq, out = ring.pop()
        assert out[0, 0] == 4 and seq == 5
        assert ring.skip_to_latest() == 0
        ring.close()


def test_threaded_producer_consumer():
    """A producer thread against the consumer, with the interpreter
    switching threads often: sequence numbers strictly increase, no frame
    is torn, and every frame is either read or counted as dropped."""
    ring = native.FrameRing((64, 64), n_slots=4)
    n = 2000
    got = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def producer():
            for i in range(n):
                ring.push(np.full((64, 64), i % 251, np.uint8))

        t = threading.Thread(target=producer)
        t.start()
        while t.is_alive() or len(ring):
            seq, out = ring.pop()
            if seq:
                assert (out == (seq - 1) % 251).all(), f"frame {seq} torn"
                got.append(seq)
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert all(b > a for a, b in zip(got, got[1:]))
    assert len(got) + ring.dropped == n
    ring.close()


def test_bad_frames_and_closed_ring_raise():
    ring = native.FrameRing((2, 3), n_slots=2)
    with pytest.raises(ValueError, match="frames got one of"):
        ring.push(np.zeros((3, 2), np.uint8))
    ring.close()
    ring.close()  # idempotent
    with pytest.raises(ValueError, match="closed"):
        ring.pop()
    with pytest.raises(ValueError, match="at least one slot"):
        native.FrameRing((2, 2), n_slots=0)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a source g++ rejects raises with the compiler's output."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


# ---------------------------------------------------------------------------
# The host resampler and the HWC -> planar conversion (src/cbv_resample.cpp)
# ---------------------------------------------------------------------------

CORNERS = np.array([[173, 133], [1100, 110], [150, 650], [1131, 680]])  # tests/test_native.py's


@pytest.fixture(scope="module")
def resample_case():
    from chessboard_vision_tpu import geometry as jgeo
    from chessboard_vision_tpu_torch import geometry as tgeo

    frame = np.random.default_rng(61).integers(0, 256, (720, 1280, 3), np.uint8)
    return (frame, jgeo.BoardGeometry.from_calibration(CORNERS),
            tgeo.BoardGeometry.from_calibration(CORNERS))


def test_host_resampler_equals_jax_static_resample(resample_case):
    """resample_gray / resample_bgr on the square query plan, bit-equal to
    the JAX package's static_resample (as tests/test_native.py holds the
    JAX resampler) and to the JAX native resampler where it built."""
    import jax.numpy as jnp
    from chessboard_vision_tpu.ops import static_resample as sr

    frame, jg, tg = resample_case
    qx, qy = tg.square_query_coords()
    host = native.HostResampler(qx, qy, tg.src_h, tg.src_w)
    plan = sr.ResamplePlan.build(*jg.square_query_coords(), jg.src_h, jg.src_w)
    b, g, r = (np.asarray(x) for x in sr.resample_bgr(jnp.asarray(sr.to_planar(frame)), plan,
                                                        jg.src_w))
    x = np.stack([b, g, r]).astype(np.int64)
    gray = ((x[2] * 9798 + x[1] * 19235 + x[0] * 3735 + (1 << 14)) >> 15).astype(np.uint8)
    got_b, got_g, got_r = host.resample_bgr(frame)
    for got, want in ((got_b, b), (got_g, g), (got_r, r)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(host.resample_gray(frame), gray)
    if jnative.AVAILABLE:
        jhost = jnative.HostResampler(*jg.square_query_coords(), jg.src_h, jg.src_w)
        np.testing.assert_array_equal(host.resample_gray(frame), jhost.resample_gray(frame))
        for got, want in zip(host.resample_bgr(frame), jhost.resample_bgr(frame)):
            np.testing.assert_array_equal(got, want)


def test_host_resampler_equals_the_ports_board_warp(resample_case):
    """On the board warp's maps the host resampler is the port's gather
    warp run op by op (warp_bilinear(contract=False), warp_board's)."""
    import torch

    from chessboard_vision_tpu_torch.ops import warp as twarp

    frame, _, tg = resample_case
    host = native.HostResampler(tg.warp_X, tg.warp_Y, tg.src_h, tg.src_w)
    dg = twarp.DeviceGeometry.from_host(tg, device="cpu")
    board = twarp.frame_to_board(torch.as_tensor(frame), dg, contract=False).numpy()
    for c, got in enumerate(host.resample_bgr(frame)):
        np.testing.assert_array_equal(got, board[..., c].reshape(-1))


def test_to_planar_native_and_bad_frames(resample_case):
    from chessboard_vision_tpu_torch.ops.layout import to_planar

    frame, _, tg = resample_case
    out = native.to_planar_native(frame)
    np.testing.assert_array_equal(out, to_planar(frame))
    if jnative.AVAILABLE:
        np.testing.assert_array_equal(out, jnative.to_planar_native(frame))
    host = native.HostResampler(tg.warp_X, tg.warp_Y, tg.src_h, tg.src_w)
    with pytest.raises(ValueError, match="HWC frames"):
        host.resample_gray(frame[:100])
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        native.to_planar_native(frame[..., 0])
