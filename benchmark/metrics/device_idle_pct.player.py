"""The device: the share of the plain traced stretch's window (first call's
start to last call's end) in which no device record ran, %."""


def read(run):
    if not run.stretches:
        return None
    s = run.stretches[0]
    return 100.0 * (1.0 - s.busy_s / s.window_s)
