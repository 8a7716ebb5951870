"""The kernels: mean launches a tick of the resample kernel, as the program
counts them in ``pipeline.resample_launches``: 1 where a tick's boards
resample in one launch, as the per-rig hall's squares do."""

from benchmark import spans


def read(run):
    return spans.mean_count(run, "pipeline.resample_launches")
