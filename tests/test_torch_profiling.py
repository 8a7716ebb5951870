"""utils/profiling of the port vs the JAX package's, on the CPU.

FpsCounter and StageTimer get the samples of tests/test_profiling.py and
must report what the JAX classes report; StageTimer's sync hook is called
with the stage's value before its clock stops. device_trace is a
torch.profiler scope: on the CPU it records the ops of its block and
writes a Chrome trace.
"""

import json
import time

import numpy as np
import pytest
import torch

from chessboard_vision_tpu.utils import profiling as jprof
from chessboard_vision_tpu_torch.utils import profiling as tprof

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)


@pytest.mark.parametrize("mod", [jprof, tprof], ids=["jax", "port"])
def test_fps_counter_window(mod):
    c = mod.FpsCounter(window=0.0)  # every update refreshes
    c.update()
    time.sleep(0.01)
    assert c.update() > 0 and c.fps > 0
    slow = mod.FpsCounter(window=3600.0)
    assert slow.update() == 0.0 and slow.fps == 0.0  # inside the window: no reading yet


def _timer_report(mod):
    t = mod.StageTimer()
    for ms in (1.0, 2.0, 3.0, 7.5, 0.25):
        t.record("infer", ms / 1e3)
    t.record("warp", 4e-3)
    out = {"p50": t.percentile("infer", 50), "p95": t.percentile("infer", 95),
           "missing": t.percentile("missing", 50), "report": t.report()}
    with t.stage("timed"):
        pass
    out["timed_n"] = t.report()["timed"]["n"]
    t.reset()
    out["after_reset"] = t.report()
    return out


def test_stage_timer_reports_what_the_jax_timer_reports():
    got, want = _timer_report(tprof), _timer_report(jprof)
    assert np.isnan(got.pop("missing")) and np.isnan(want.pop("missing"))
    assert got == want
    assert np.isclose(got["p50"], 2e-3) and got["report"]["infer"]["n"] == 5
    assert got["timed_n"] == 1 and got["after_reset"] == {}


def test_stage_timer_syncs_on_the_stage_value():
    seen = []
    t = tprof.StageTimer(sync=seen.append)
    with t.stage("step", sync_value="out"):
        pass
    with t.stage("no_value"):
        pass
    assert seen == ["out"]
    assert t.report()["step"]["n"] == t.report()["no_value"]["n"] == 1


def test_device_trace_records_the_block_and_writes_a_chrome_trace(tmp_path):
    x = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    with tprof.device_trace(str(tmp_path / "trace")) as prof:
        y = (x @ x).sum()
    assert float(y) > 0
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "trace" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
