"""The camera loop: 95th percentile (nearest rank) of how late each timed
``on_frame`` began after its frame's due time, ms."""

from benchmark.stats import nearest_rank


def read(run):
    return nearest_rank(run.wait_s, 0.95) * 1e3 if len(run.wait_s) else None
