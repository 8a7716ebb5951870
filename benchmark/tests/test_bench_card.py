"""Short runs of the benchmark's own cells on the card (marked ``cuda``; each
test skips where no card is present): correct, no module of JAX or of the
JAX package loaded, and a traced run's stretches read."""

import time

import pytest

from benchmark import run


def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["player_720p.live30", "hall_1080p.capacity"])
def test_cell_on_the_card(workload):
    card()
    cell = run.find_cell(run.ROOT, workload)
    r, _ = run.run_cell(cell, 2**31 + 99, 3.0, True, t_start=time.perf_counter())
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and 0 < r["device"]["busy_s"] < r["device"]["window_s"]
    assert set(r["metrics"]) == {m["name"] for m in cell.per_layer}
