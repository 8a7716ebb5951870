"""``resample_launches.hall`` on a synthetic Record over a filled call table:
the mean over the window's calls of the program's counter
``pipeline.resample_launches`` (a call without it reads 0), and None where
no call of the window counts it, as at a program without the counter."""

import numpy as np
import pytest

from benchmark import run, spans
from chessboard_vision_tpu_torch.utils import profiling as tprof

NAME = "resample_launches.hall"
LAUNCHES = [1, 1, 0, 2, 1, 1, 1, 1, 1, 1]  # 3 warm-up calls, 5 timed, 2 traced


class Stretch:
    def __init__(self, calls):
        self.calls = calls


def record(call_s, stretches=()) -> run.Record:
    return run.Record(window_s=1.0, setup_s=0.0, latency_s=np.zeros(0), frames_done=0,
                      wait_s=np.zeros(0), call_s=np.asarray(call_s, np.float64),
                      step_s=np.zeros(len(call_s)), stretches=list(stretches),
                      b1_shape=(1, 1, 1), config={})


@pytest.fixture(autouse=True)
def empty_table():
    tprof.clear()
    yield
    tprof.clear()


@pytest.mark.parametrize("counted", [True, False])
def test_the_reader_gives_the_window_mean_or_none(counted):
    for n in LAUNCHES:
        with tprof.span("session.on_frames"):
            with tprof.span("pipeline.step"):
                if counted and n:
                    tprof.count("pipeline.resample_launches", n)
    r = record([1.0] * 5, [Stretch(1), Stretch(1)])
    assert spans.window(r) == tprof.recorded_calls()[3:8]
    got = run.metric_reader(NAME)(r)
    assert got == (pytest.approx(np.mean(LAUNCHES[3:8]), rel=1e-12) if counted else None)


def test_the_metric_is_declared_for_the_plain_hall():
    """Listed in the plain hall, whose tick resamples every board's squares
    in one launch; not in the player, whose launch sits in a graph."""
    names = ("hall_1080p.capacity", "hall_1080p_enhanced.capacity", "player_720p.live30")
    cells = {name: run.find_cell(run.ROOT, name) for name in names}
    listed = {name: NAME in [m["name"] for m in c.per_layer] for name, c in cells.items()}
    assert listed == {"hall_1080p.capacity": True, "hall_1080p_enhanced.capacity": False,
                      "player_720p.live30": False}
