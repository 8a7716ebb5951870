"""ctypes binding of the port's host runtime: the SPSC frame ring.

``src/cbv_ring.cpp`` is compiled with g++ at first use (the first
``FrameRing``), never at import, into ``_build/`` (git-ignored) under a
file name keyed on a hash of the source and the flags, as the CUDA kernels
are built into ``kernels/_build/``. A failed build raises: where the JAX
package's binding falls back to ``AVAILABLE = False``, the port has no
fallback, and a caller that wants no ring says so (play_lichess
``--no-ring`` polls the camera inline).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(NATIVE_DIR, "src", "cbv_ring.cpp")
BUILD_DIR = os.path.join(NATIVE_DIR, "_build")
# -march=x86-64-v2 (SSE4.2/POPCNT) rather than -march=native, as the JAX
# package's Makefile: the library may be built on one host and run on another.
CXX_FLAGS = ("-O3", "-march=x86-64-v2", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the ring into ``_build/libcbv_ring_<hash>.so`` unless an
    up-to-date library is there; returns its path. Raises on failure."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()
    lib = os.path.join(BUILD_DIR, f"libcbv_ring_{digest[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build the frame ring ({SOURCE}): {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed on {SOURCE} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the ring library, once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        u8p, i64, ring = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_void_p
        lib.cbv_ring_create.restype = ring
        lib.cbv_ring_create.argtypes = [i64, i64]
        lib.cbv_ring_destroy.restype = None
        lib.cbv_ring_destroy.argtypes = [ring]
        for fn in ("cbv_ring_push", "cbv_ring_pop"):
            getattr(lib, fn).restype = i64
            getattr(lib, fn).argtypes = [ring, u8p]
        for fn in ("cbv_ring_skip_to_latest", "cbv_ring_size", "cbv_ring_dropped"):
            getattr(lib, fn).restype = i64
            getattr(lib, fn).argtypes = [ring]
        _lib = lib
    return _lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class FrameRing:
    """SPSC frame ring (capture thread -> pipeline thread) of ``n_slots``
    u8 frames of ``frame_shape``: ``push`` copies a frame in and overwrites
    the oldest when full; ``pop`` copies the oldest surviving frame out
    with its sequence number (1, 2, ...; frames the producer overwrote
    before they were read count in ``dropped``); ``skip_to_latest`` drops
    the backlog but the newest frame."""

    def __init__(self, frame_shape: Tuple[int, ...], n_slots: int = 4):
        if n_slots < 1:
            raise ValueError(f"FrameRing needs at least one slot, got {n_slots}")
        self._lib = load()
        self.shape = tuple(int(d) for d in frame_shape)
        self.slot_bytes = int(np.prod(self.shape))
        self._ring = self._lib.cbv_ring_create(self.slot_bytes, int(n_slots))

    def _live(self):
        if not self._ring:
            raise ValueError("FrameRing is closed")
        return self._ring

    def push(self, frame: np.ndarray) -> int:
        """Copy a frame in; returns its sequence number."""
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.shape != self.shape:
            raise ValueError(f"FrameRing of {self.shape} frames got one of {frame.shape}")
        return self._lib.cbv_ring_push(self._live(), _u8(frame))

    def pop(self):
        """(sequence number, frame) of the next surviving frame, or
        (0, None) when the ring is empty."""
        out = np.empty(self.shape, np.uint8)
        seq = self._lib.cbv_ring_pop(self._live(), _u8(out))
        return (seq, out) if seq else (0, None)

    def skip_to_latest(self) -> int:
        """Drop all but the newest unread frame; returns the frames skipped."""
        return self._lib.cbv_ring_skip_to_latest(self._live())

    def __len__(self) -> int:
        return self._lib.cbv_ring_size(self._live())

    @property
    def dropped(self) -> int:
        """Frames the producer overwrote before the consumer read them."""
        return self._lib.cbv_ring_dropped(self._live())

    def close(self):
        if self._ring:
            self._lib.cbv_ring_destroy(self._ring)
            self._ring = None
