"""The kernel: the Hough score matmul's share of its roofline, %: the least
time of its logical work (roofline.b1_bound at the configuration's
roofline.b1_shape) over the device time of every record launched under the
port's score-matmul call site a tick, whatever its kernel."""

from benchmark.roofline import b1_bound


def read(run):
    if len(run.stretches) < 2 or run.stretches[1].b1_s <= 0:
        return None
    s = run.stretches[1]
    return 100.0 * b1_bound(*run.b1_shape)[0] / (s.b1_s / s.calls)
