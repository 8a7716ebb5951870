"""The N-stream pipeline: mean host time a tick inside
``MultiStreamPipeline.step``, ms (packing and upload of the host frames, the
launches' enqueue)."""

import numpy as np


def read(run):
    return float(np.mean(run.step_s)) * 1e3 if len(run.step_s) else None
