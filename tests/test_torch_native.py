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
