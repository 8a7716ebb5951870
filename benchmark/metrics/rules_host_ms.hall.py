"""The session: mean host time a tick in the program's ``session.smart_scan``
and ``session.rules`` spans (the boards' legal-move masks before the step,
the stability gate and move inference after it), ms."""

from benchmark import spans


def read(run):
    return spans.mean_ms(run, "session.smart_scan", "session.rules")
