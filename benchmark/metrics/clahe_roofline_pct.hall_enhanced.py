"""The kernels: CLAHE's share of its roofline, %: the least time of its two
launches' logical work a tick, the histograms with their LUTs (B3) and the
LUT apply (B4), over the device time of every record launched under the
port's CLAHE call site a tick.

The work is counted from the configuration, as chip_smoke.py counts it, on
each board's B x B u8 L plane (B = min(frame_size) - 100) cut into 8 x 8
tiles of th = ceil(B / 8) rows, with n_lut = 64 x 256 LUT entries: B3 reads
the plane and writes i32 histograms and f32 LUTs (B^2 + 8 n_lut bytes), one
count per pixel of the padded plane ((8 th)^2 operations); B4 reads the plane
and the LUTs and writes the plane (2 B^2 + 4 n_lut bytes), ~10 f32
operations a pixel. Each at its own bound, bytes or operations."""

from benchmark.roofline import F32_FLOPS, bound

TILES = 8


def bounds_s(config: dict) -> tuple:
    """(B3's, B4's) least seconds a tick: all the configuration's boards."""
    b, n = min(config["frame_size"]) - 100, config["boards"]
    th = -(-b // TILES)
    n_lut = TILES * TILES * 256
    hist = bound((b * b + 8 * n_lut) * n, (TILES * th) ** 2 * n, F32_FLOPS)[0]
    apply = bound((2 * b * b + 4 * n_lut) * n, 10 * b * b * n, F32_FLOPS)[0]
    return hist, apply


def read(run):
    if len(run.stretches) < 2:
        return None
    s = run.stretches[1]
    t = s.site_s.get("kernels/clahe.py", 0.0)
    return 100.0 * sum(bounds_s(run.config)) / (t / s.calls) if t > 0 else None
