"""The pipeline: median host time inside ``VisionPipeline.step`` over timed
calls, ms (the upload and the launches' enqueue; the step does not wait)."""

import numpy as np


def read(run):
    return float(np.median(run.step_s)) * 1e3 if len(run.step_s) else None
