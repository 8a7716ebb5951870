"""Frames completed (boards x calls) over the whole window, a second."""


def read(run):
    return run.frames_done / run.window_s
