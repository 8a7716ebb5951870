"""The pipeline: mean host time a tick in the program's ``pipeline.enhance``
span (the boards' color warps and their enhancement enqueued, inside
``pipeline.enqueue``), ms."""

from benchmark import spans


def read(run):
    return spans.mean_ms(run, "pipeline.enhance")
