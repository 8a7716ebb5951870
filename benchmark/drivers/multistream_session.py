"""Driver of the N-board entry: ``MultiStreamSession`` on the card, one
calibration a rig (a list of N geometries, so each rig has its own resample
plan).

Set-up builds it from the configuration's corners and captures every
board's reference (``capture_reference``). A call is ``on_frames`` on one
tick's host (N, H, W, 3) u8 frames. The spans: ``step_s`` is the host time
inside the session's ``ms.step`` (wrapped on the instance), so a call's wall
time less it is the session's own host time (the readback and the N boards'
rules). The wrapper also keeps each tick's outputs, on the card, for the
comparison after the window.
"""

from __future__ import annotations

import time

import numpy as np

# The plain reference of this entry: a session of reference/sessions.py.
REFERENCE = "ReferenceHall"


class Driver:
    def __init__(self, config: dict, corners: list, device: str):
        from chessboard_vision_tpu_torch.geometry import BoardGeometry
        from chessboard_vision_tpu_torch.parallel.session import MultiStreamSession

        h, w = config["frame_size"]
        self.boards = len(corners)
        geometries = [BoardGeometry.from_calibration(np.asarray(c).round().astype(int),
                                                     display_size=(w, h)) for c in corners]
        p = config["pipeline"]
        self.session = MultiStreamSession(geometries, n_streams=self.boards, device=device,
                                          hough_backend=p["hough_backend"],
                                          with_enhancer=p["use_enhancer"])
        self.step_s = 0.0
        self._ticks = []  # each tick's (StepOutputs, blocked) on the card
        ms = self.session.ms
        step = ms.step

        def timed_step(*a, **kw):
            t = time.perf_counter()
            try:
                state, out = step(*a, **kw)
            finally:
                self.step_s = time.perf_counter() - t
            self._ticks.append((out.step, out.noise.blocked))
            return state, out

        ms.step = timed_step

    def capture(self, frames: np.ndarray):
        self.session.capture_reference(frames)

    def call(self, frames: np.ndarray) -> list:
        return [None if m is None else m.uci() for m in self.session.on_frames(frames)]

    @property
    def outputs(self) -> list:
        return [type(o)(*(x.cpu().numpy() for x in o)) for o, _ in self._ticks]

    def blocked(self):
        return np.stack([b.cpu().numpy() for _, b in self._ticks]) if self._ticks else None

    def final_fens(self) -> list:
        return [st.game.get_fen() for st in self.session.streams]

    def close(self):
        self.session = None
        self._ticks = []
