"""The ops: device ms a tick in the enhance stage (B2-B4 and the enhancer's
own ops; trace.STAGE_OF), from the traced stretch with Python stacks."""


def read(run):
    if len(run.stretches) < 2 or "enhance" not in run.stretches[1].stage_s:
        return None
    s = run.stretches[1]
    return s.stage_s["enhance"] / s.calls * 1e3
