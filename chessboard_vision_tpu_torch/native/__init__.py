"""ctypes binding of the port's host runtime: the SPSC frame ring, the
host resampler and the HWC -> planar conversion.

``src/cbv_ring.cpp`` (the ring) and ``src/cbv_resample.cpp`` (the
resampler, ``to_planar_native``) are each compiled with g++ at first use
(the first ``FrameRing``, ``HostResampler`` call or ``to_planar_native``),
never at import, into ``_build/`` (git-ignored) under a file name keyed on
a hash of the source and the flags, as the CUDA kernels are built into
``kernels/_build/``. A failed build raises: where the JAX package's
binding falls back to ``AVAILABLE = False``, the port has no fallback, and
a caller that wants no ring says so (play_lichess ``--no-ring`` polls the
camera inline).
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
RESAMPLE_SOURCE = os.path.join(NATIVE_DIR, "src", "cbv_resample.cpp")
BUILD_DIR = os.path.join(NATIVE_DIR, "_build")
# -march=x86-64-v2 (SSE4.2/POPCNT) rather than -march=native, as the JAX
# package's Makefile: the library may be built on one host and run on another.
CXX_FLAGS = ("-O3", "-march=x86-64-v2", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib: Optional[ctypes.CDLL] = None
_resample_lib: Optional[ctypes.CDLL] = None


def build(source: Optional[str] = None) -> str:
    """Compile ``source`` (default: the ring's) into
    ``_build/lib<name>_<hash>.so`` unless an up-to-date library is there;
    returns its path. Raises on failure."""
    source = source or SOURCE
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()
    name = os.path.splitext(os.path.basename(source))[0]
    lib = os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build {source}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed on {source} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
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


def load_resample() -> ctypes.CDLL:
    """Build (if needed) and load the resampler library, once per process."""
    global _resample_lib
    if _resample_lib is None:
        lib = ctypes.CDLL(build(RESAMPLE_SOURCE))
        u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
        f32p, i64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
        lib.cbv_resample_bgr.argtypes = [u8p, i64, i32p, f32p, f32p, u8p, i64, u8p, u8p, u8p]
        lib.cbv_resample_gray.argtypes = [u8p, i64, i32p, f32p, f32p, u8p, i64, u8p]
        lib.cbv_to_planar.argtypes = [u8p, i64, i64, u8p]
        for fn in ("cbv_resample_bgr", "cbv_resample_gray", "cbv_to_planar"):
            getattr(lib, fn).restype = None
        _resample_lib = lib
    return _resample_lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class HostResampler:
    """Bilinear warp and extraction on the host for the queries (X, Y)
    (any shape, flattened) into an (src_h, src_w) HWC u8 frame: the
    arithmetic of ops/warp.warp_bilinear(contract=False), a constant-0
    border. The plan (each query's anchor pixel, fractions and out-of-frame
    taps) is built here once; each call is one pass of the C++ loop."""

    def __init__(self, X, Y, src_h: int, src_w: int):
        X = np.asarray(X, np.float32).reshape(-1)
        Y = np.asarray(Y, np.float32).reshape(-1)
        ix = np.floor(X).astype(np.int64)
        iy = np.floor(Y).astype(np.int64)
        self.fx = (X - ix).astype(np.float32)
        self.fy = (Y - iy).astype(np.float32)
        oob = np.zeros(X.size, np.uint8)
        for bit, (dy, dx) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
            yy, xx = iy + dy, ix + dx
            bad = ~((yy >= 0) & (yy < src_h) & (xx >= 0) & (xx < src_w))
            oob |= bad.astype(np.uint8) << bit
        # An anchor outside the frame reads nothing: all four taps are 0.
        anchor_bad = ~((iy >= 0) & (iy < src_h) & (ix >= 0) & (ix < src_w))
        self.oob = oob | np.where(anchor_bad, 0x0F, 0).astype(np.uint8)
        self.idx = (np.clip(iy, 0, src_h - 1) * src_w + np.clip(ix, 0, src_w - 1)).astype(np.int32)
        self.src_h, self.src_w = int(src_h), int(src_w)
        self.n = X.size
        self._lib = load_resample()

    def _frame(self, frame_hwc) -> np.ndarray:
        frame = np.ascontiguousarray(frame_hwc, dtype=np.uint8)
        if frame.shape != (self.src_h, self.src_w, 3):
            raise ValueError(f"HostResampler of {self.src_h}x{self.src_w} HWC frames got "
                             f"{frame.shape}")
        return frame

    def _plan(self):
        return (self.src_w, self.idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                self.fx.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.fy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), _u8(self.oob), self.n)

    def resample_gray(self, frame_hwc: np.ndarray) -> np.ndarray:
        """(n,) u8: the cv2 fixed-point gray of each query's resampled BGR."""
        frame = self._frame(frame_hwc)
        out = np.empty(self.n, np.uint8)
        self._lib.cbv_resample_gray(_u8(frame), *self._plan(), _u8(out))
        return out

    def resample_bgr(self, frame_hwc: np.ndarray):
        """(b, g, r), each (n,) u8: each query's resampled channels."""
        frame = self._frame(frame_hwc)
        b, g, r = (np.empty(self.n, np.uint8) for _ in range(3))
        self._lib.cbv_resample_bgr(_u8(frame), *self._plan(), _u8(b), _u8(g), _u8(r))
        return b, g, r


def to_planar_native(frame_hwc: np.ndarray) -> np.ndarray:
    """(H, W, 3) u8 HWC -> (3, H, W) u8 planar, one C++ pass."""
    frame = np.ascontiguousarray(frame_hwc, dtype=np.uint8)
    if frame.ndim != 3 or frame.shape[-1] != 3:
        raise ValueError(f"to_planar_native takes an (H, W, 3) frame, got {frame.shape}")
    h, w = frame.shape[:2]
    out = np.empty((3, h, w), np.uint8)
    load_resample().cbv_to_planar(_u8(frame), h, w, _u8(out))
    return out


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
