"""95th percentile (nearest rank) of every offered frame's latency, ms: from
its due time (open loop) or hand-over (closed loop) to the return of the
session call that took it; a frame not returned in the window counts to the
window's end."""

from benchmark.stats import nearest_rank


def read(run):
    return nearest_rank(run.latency_s, 0.95) * 1e3
