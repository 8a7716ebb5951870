"""The ops: device ms a tick in the hough stage (Canny, the conv Hough and
its score matmul; trace.STAGE_OF), from the traced stretch with Python stacks."""


def read(run):
    if len(run.stretches) < 2 or "hough" not in run.stretches[1].stage_s:
        return None
    s = run.stretches[1]
    return s.stage_s["hough"] / s.calls * 1e3
