"""The ops: device ms a tick in the color stage (ops/color.py: the enhancer's
Lab round trip and the enhanced boards' gray; trace.STAGE_OF), from the
traced stretch with Python stacks."""


def read(run):
    if len(run.stretches) < 2 or "color" not in run.stretches[1].stage_s:
        return None
    s = run.stretches[1]
    return s.stage_s["color"] / s.calls * 1e3
