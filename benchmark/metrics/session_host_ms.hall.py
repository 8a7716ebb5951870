"""The session: mean over timed ticks of ``on_frames``' wall time less its
``ms.step`` call, ms (the readback and the N boards' rules)."""

import numpy as np


def read(run):
    return float(np.mean(run.call_s - run.step_s)) * 1e3 if len(run.call_s) else None
