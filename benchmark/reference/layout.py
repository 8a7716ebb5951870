# Frozen copy of chessboard_vision_tpu_torch/ops/layout.py at commit 9f9af32, for the
# benchmark's plain reference: imports rewritten to this folder, nothing else
# changed unless a "reference:" comment says so.
"""Square-layout and frame-layout helpers (host numpy).

The 64-square axis is indexed rank-major: flat = rank * 8 + file, with
a1 = (file 0, rank 0), as everywhere in the JAX package.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

SquareTuple = Tuple[int, int]


def positions_to_mask(positions: Iterable[SquareTuple]) -> np.ndarray:
    """(file, rank) tuples -> (64,) bool mask (out-of-board tuples dropped)."""
    m = np.zeros(64, bool)
    for f, r in positions:
        if 0 <= f < 8 and 0 <= r < 8:
            m[r * 8 + f] = True
    return m


def to_planar(frame_hwc) -> np.ndarray:
    """HWC BGR (camera layout) -> contiguous planar (3, H, W)."""
    return np.ascontiguousarray(np.moveaxis(np.asarray(frame_hwc), -1, 0))
