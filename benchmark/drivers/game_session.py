"""Driver of the single-board entry: a headless ``GameSession`` on the card.

Set-up calibrates it from the configuration's corners
(``on_calibration_requested(config=...)``) and captures the reference from
the first frame (``capture_reference_frame``). A call is ``on_frame`` on one
host (H, W, 3) u8 frame. The spans: ``step_s`` is the host time inside the
session's ``pipeline.step`` (wrapped on the instance), so a call's wall time
less it is the session's own host time (the readback wait, the copy back and
the rules).
"""

from __future__ import annotations

import time

import numpy as np

# The plain reference of this entry: a session of reference/sessions.py.
REFERENCE = "ReferencePlayer"


class Driver:
    boards = 1

    def __init__(self, config: dict, corners: list, device: str):
        from chessboard_vision_tpu_torch.session.game_session import GameSession

        self.session = GameSession(device=device, hough_backend=config["pipeline"]["hough_backend"])
        h, w = config["frame_size"]
        self.session.on_calibration_requested(config={
            "corners": np.asarray(corners[0]).round().astype(int).tolist(),
            "display_size": [w, h],
            "use_enhancer": config["pipeline"]["use_enhancer"],
        })
        self.step_s = 0.0
        self.outputs = []  # the program's StepOutputs a call, host (1, 64) arrays
        pipeline = self.session.pipeline
        step = pipeline.step

        def timed_step(*a, **kw):
            t = time.perf_counter()
            try:
                return step(*a, **kw)
            finally:
                self.step_s = time.perf_counter() - t

        pipeline.step = timed_step

    def capture(self, frames: np.ndarray):
        self.session.capture_reference_frame(frames[0])

    def call(self, frames: np.ndarray) -> list:
        """One call on the board's frame (frames[0]); -> [committed uci or None]."""
        move = self.session.on_frame(frames[0])
        self.outputs.append(self.session.last_outputs)
        return [None if move is None else move.uci()]

    def blocked(self):
        return None  # the host noise FSM's state is not a step output

    def final_fens(self) -> list:
        return [self.session.game.get_fen()]

    def close(self):
        self.session = None
