"""The program's own spans and counters over a run's timed window.

The port records every session call in its call table
(``chessboard_vision_tpu_torch.utils.profiling``): one call a frame or a
tick, with each span's time and each counter by name. A traced run makes
``sum(s.calls for s in run.stretches)`` more calls after the window, and
nothing calls the port after those (the reference's replay imports none of
it), so the window's calls are the ``len(run.call_s)`` calls before them.
The metrics are means over those calls, as the harness's other host
metrics of the hall are.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# The spans that open a session call: GameSession.on_frame, MultiStreamSession.on_frames.
ROOTS = ("session.on_frame", "session.on_frames")


def window(run) -> Optional[tuple]:
    """The program's calls of the timed window, in order; None where the
    program keeps no call table, the table holds fewer calls than the run
    made, or a call's opening span is longer than the harness's wall time of
    the call it is matched with (the calls do not line up)."""
    try:
        from chessboard_vision_tpu_torch.utils.profiling import recorded_calls
    except ImportError:
        return None
    n, tail = len(run.call_s), sum(s.calls for s in run.stretches)
    calls = recorded_calls()
    if n == 0 or len(calls) < n + tail:
        return None
    calls = calls[len(calls) - tail - n:len(calls) - tail]
    for call, wall_s in zip(calls, run.call_s):
        if call.root not in ROOTS or call.spans[call.root].total_ns > wall_s * 1e9:
            return None
    return calls


def mean_ms(run, *names: str) -> Optional[float]:
    """The mean over the window's calls of the summed time of the spans
    ``names``, ms; None where no call has one of them."""
    calls = window(run)
    if calls is None or not any(name in c.spans for c in calls for name in names):
        return None
    return float(np.mean([sum(c.spans[name].total_ns for name in names if name in c.spans)
                          for c in calls])) / 1e6


def mean_count(run, name: str) -> Optional[float]:
    """The mean over the window's calls of the counter ``name``; None where
    no call counts it."""
    calls = window(run)
    if calls is None or not any(name in c.counts for c in calls):
        return None
    return float(np.mean([c.counts.get(name, 0) for c in calls]))
