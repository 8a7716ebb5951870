"""Median (nearest rank) of every offered frame's latency, ms."""

from benchmark.stats import nearest_rank


def read(run):
    return nearest_rank(run.latency_s, 0.50) * 1e3
