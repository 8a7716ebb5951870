"""The session: mean host time a tick in the program's
``session.device_wait`` span (the wait for the card's work on the step's
outputs, before the readback), ms."""

from benchmark import spans


def read(run):
    return spans.mean_ms(run, "session.device_wait")
