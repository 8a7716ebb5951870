"""Order statistics of the benchmark's samples."""

from __future__ import annotations

import math

import numpy as np


def nearest_rank(values, q: float) -> float:
    """The q-quantile by nearest rank: the smallest sample with at least a
    share q of the samples at or below it."""
    v = np.sort(np.asarray(values, np.float64))
    return float(v[max(0, math.ceil(q * len(v)) - 1)])
