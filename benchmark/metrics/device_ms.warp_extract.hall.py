"""The ops: device ms a tick in the warp_extract stage (trace.STAGE_OF), from
the traced stretch with Python stacks."""


def read(run):
    if len(run.stretches) < 2 or "warp_extract" not in run.stretches[1].stage_s:
        return None
    s = run.stretches[1]
    return s.stage_s["warp_extract"] / s.calls * 1e3
