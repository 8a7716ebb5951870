"""The pipeline: mean host time a tick in the program's ``pipeline.upload``
spans (the page-locked buffer taken, the boards' frames packed into it with
their flags, the H2D copy enqueued), ms."""

from benchmark import spans


def read(run):
    return spans.mean_ms(run, "pipeline.upload")
