"""The pipeline: mean host time a tick in the program's ``pipeline.enqueue``
span (the folded tick's launches, ``_tick_slots``), ms."""

from benchmark import spans


def read(run):
    return spans.mean_ms(run, "pipeline.enqueue")
