"""The session: median over timed calls of ``on_frame``'s wall time less its
``pipeline.step`` call, ms (the readback wait, the copy back, the rules)."""

import numpy as np


def read(run):
    return float(np.median(run.call_s - run.step_s)) * 1e3 if len(run.call_s) else None
