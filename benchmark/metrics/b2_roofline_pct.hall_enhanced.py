"""The kernel: the bilateral filter's (B2) share of its roofline, %: the least
time of its logical work a tick over the device time of every record
launched under the port's bilateral call site a tick.

The work is counted from the configuration, as chip_smoke.py counts it: the
boards' 3 x B x B u8 planes read once and written once, and 49 taps (the d =
9 disk) of 15 f32 operations besides the exp at each of a board's B x B
pixels, at the f32 peak; B = min(frame_size) - 100, the warped board."""

from benchmark.roofline import F32_FLOPS, bound

TAPS, FLOPS_PER_TAP = 49, 15


def bound_s(config: dict) -> float:
    """B2's least seconds a tick: all the configuration's boards."""
    b, n = min(config["frame_size"]) - 100, config["boards"]
    return bound(2 * 3 * b * b * n, TAPS * FLOPS_PER_TAP * b * b * n, F32_FLOPS)[0]


def read(run):
    if len(run.stretches) < 2:
        return None
    s = run.stretches[1]
    t = s.site_s.get("kernels/bilateral.py", 0.0)
    return 100.0 * bound_s(run.config) / (t / s.calls) if t > 0 else None
