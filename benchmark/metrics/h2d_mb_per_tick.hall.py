"""The pipeline: mean bytes a tick that the program counts as uploaded to
the card (``pipeline.h2d_bytes``: frames and flags), MB (10^6 bytes)."""

from benchmark import spans


def read(run):
    n = spans.mean_count(run, "pipeline.h2d_bytes")
    return None if n is None else n / 1e6
