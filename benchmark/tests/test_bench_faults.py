"""The comparison catches a broken timed path: with the program broken
underneath a whole run (on the CPU, at a reduced size), ``correct`` comes
out false, once for each fault a cell can have: a step that returns its
state unchanged, half of the batch left out (its answers taken from the
rest), an answer altered where it is produced. (The exchange between
chips has no cell: every cell is on one chip.) The lower-precision control
in the program's place fails the limits too."""

import pytest
import torch

from benchmark.tests import tiny


def broken_core(monkeypatch, fault):
    from chessboard_vision_tpu_torch.models.pipeline import VisionPipeline

    core = VisionPipeline._step_core

    def step_core(self, state, *a, **kw):
        new, out = core(self, state, *a, **kw)
        if fault == "state":
            return state, out
        occ = out.occupancy.clone()
        occ[0] = ~occ[0]  # square a1 of the first board, every call
        return new, out._replace(occupancy=occ)

    monkeypatch.setattr(VisionPipeline, "_step_core", step_core)


@pytest.mark.parametrize("fault", ["state", "answer"])
@pytest.mark.parametrize("which", ["player", "hall"])
def test_a_broken_step_is_not_correct(monkeypatch, fault, which):
    broken_core(monkeypatch, fault)
    r = tiny.run_cpu(tiny.player() if which == "player" else tiny.hall())
    assert r["correct"] is False
    assert any(v["value"] > v["limit"] for v in r["checks"].values())


def test_half_the_batch_left_out(monkeypatch):
    """The hall's tick answers for the first half of its boards only; the
    others take those answers."""
    from chessboard_vision_tpu_torch.parallel import multistream

    tick = multistream.MultiStreamPipeline._tick_slots

    def half(self, state, inputs):
        new, out = tick(self, state, inputs)
        n = out.step.occupancy.shape[0]
        k = n // 2
        step = out.step._replace(**{f: torch.cat([x[:k], x[:n - k]])
                                    for f, x in out.step._asdict().items()})
        return new, out._replace(step=step)

    monkeypatch.setattr(multistream.MultiStreamPipeline, "_tick_slots", half)
    r = tiny.run_cpu(tiny.hall(boards=2))
    assert r["correct"] is False


@pytest.mark.parametrize("which", ["player", "hall"])
def test_the_control_fails_the_limits(which):
    """The reference with its resample in bfloat16, in the program's place,
    reads above a limit; the program itself reads within them."""
    r = tiny.run_cpu(tiny.player() if which == "player" else tiny.hall(), seconds=4.0,
                     control=True)
    assert r["correct"] is True
    assert any(v["value"] > v["limit"] for v in r["control"].values()), r["control"]
