"""The kernels: mean launches a tick of the bilateral (B2) and of CLAHE's
histograms with LUTs (B3) and LUT apply (B4), as the program counts them in
``pipeline.enhance_launches``: 3 where each runs all boards in one launch."""

from benchmark import spans


def read(run):
    return spans.mean_count(run, "pipeline.enhance_launches")
