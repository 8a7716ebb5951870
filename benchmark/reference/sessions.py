"""The plain reference of the two sessions' rules, over ReferencePipeline.

Frozen copies, at commit 9f9af32, of the host control plane of
chessboard_vision_tpu_torch/session/game_session.py (``GameSession.on_frame``
with ``_smart_scan_set`` and ``_process_stable_move``; no drift check, no
cooldown in frames, no UI) and of chessboard_vision_tpu_torch/parallel/
session.py (``MultiStreamSession.on_frames`` with ``_smart_scan_mask`` and
``_process_stable_move``; the noise FSM on the device). The wall clock that
the sessions read for the 2 s post-move cooldown is given here: the
benchmark passes the host time at which the program's call for the same
frame returned.

Each replay returns, for every call, the step's outputs as host numpy
(n, 64) arrays, and keeps each board's commits as (call index, uci).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import chesslib as chess
from .game_state import GameState
from .inference import infer_move_from_diff
from .layout import positions_to_mask
from .noise import NoiseHandler, NoiseState
from .fsm import init_state as fsm_init_state
from .fsm import noise_step
from .pipeline import ReferencePipeline, StepOutputs

STABILITY_REQUIRED = 20
MOVE_COOLDOWN = 2.0
FULL_SCAN_PERIOD = 30


def occupancy_to_set(occ) -> set:
    occ = np.asarray(occ)
    return {(sq % 8, sq // 8) for sq in range(64) if occ[sq]}


def to_host(out: StepOutputs, n: int) -> StepOutputs:
    return StepOutputs(*(x.cpu().numpy().reshape(n, 64) for x in out))


class _Board:
    def __init__(self):
        self.game = GameState()
        self.stable_occupancy = None
        self.stable_count = 0
        self.last_move_time = 0.0
        self.refresh_next = False
        self.commits: List[tuple] = []

    def scan_squares(self) -> set:
        squares = set(self.game.get_board_occupancy())
        for move in self.game.board.legal_moves:
            squares.add((chess.square_file(move.to_square), chess.square_rank(move.to_square)))
        return squares

    def stable_move(self, vision: set, blocked: bool, now: float, call: int):
        expected = self.game.get_board_occupancy()
        missing = expected - vision
        extra = vision - expected
        if len(missing) + len(extra) > 4:
            self.stable_count = 0
            self.stable_occupancy = set()
        elif self.stable_occupancy == vision:
            self.stable_count += 1
        else:
            self.stable_occupancy = set(vision)
            self.stable_count = 1
        if (self.stable_count >= STABILITY_REQUIRED and (now - self.last_move_time) > MOVE_COOLDOWN
                and not blocked):
            move = infer_move_from_diff(self.game, missing, extra, vision)
            if move and move in self.game.board.legal_moves:
                self.game.board.push(move)
                self.last_move_time = now
                self.refresh_next = True
                self.stable_count = 0
                self.commits.append((call, move.uci()))
                return move
        return None


class ReferencePlayer:
    """GameSession's rules over one board (GameSession.on_frame)."""

    def __init__(self, pipeline: ReferencePipeline):
        self.pipe = pipeline
        self.state = pipeline.init_state()
        self.board = _Board()
        self.noise = NoiseHandler()
        self.frame_count = 0

    def capture(self, frames: torch.Tensor):
        self.state = self.pipe.capture(self.state, frames)

    def call(self, frames: torch.Tensor, now: float):
        """``on_frame`` on frames (1, H, W, 3) -> (StepOutputs of (1, 64) host
        arrays, None: the host noise FSM's state is no step output)."""
        self.frame_count += 1
        b = self.board
        given = self.frame_count % FULL_SCAN_PERIOD != 0
        mask = positions_to_mask(b.scan_squares()) if given else np.zeros(64, bool)
        refresh, b.refresh_next = b.refresh_next, False
        self.state, out = self.pipe.step(self.state, frames, mask[None], [given], [refresh])
        out = to_host(out, 1)
        noise_state, _ = self.noise.process(occupancy_to_set(out.visual_changes[0]))
        vision = occupancy_to_set(out.occupancy[0])
        blocked = noise_state == NoiseState.NOISE_ACTIVE
        if b.stable_move(vision, blocked, now, self.frame_count - 1):
            self.noise.reset()
        return out, None

    @property
    def boards(self) -> list:
        return [self.board]


class ReferenceHall:
    """MultiStreamSession's rules over n boards (MultiStreamSession.on_frames)."""

    def __init__(self, pipeline: ReferencePipeline):
        self.pipe = pipeline
        self.state = pipeline.init_state()
        self.fsm = fsm_init_state(pipeline.n, device=pipeline.device)
        self.boards = [_Board() for _ in range(pipeline.n)]
        self.frame_count = 0

    def capture(self, frames: torch.Tensor):
        self.state = self.pipe.capture(self.state, frames)

    def call(self, frames: torch.Tensor, now: float):
        """``on_frames`` on frames (n, H, W, 3) -> (StepOutputs of (n, 64)
        host arrays, (n,) blocked flags)."""
        self.frame_count += 1
        n = self.pipe.n
        given = self.frame_count % FULL_SCAN_PERIOD != 0
        if given:
            masks = np.stack([positions_to_mask(b.scan_squares()) for b in self.boards])
        else:
            masks = np.zeros((n, 64), bool)
        refresh = np.array([b.refresh_next for b in self.boards])
        for b in self.boards:
            b.refresh_next = False
        self.state, out = self.pipe.step(self.state, frames, masks, [given] * n, refresh)
        self.fsm, fsm_out = noise_step(self.fsm, out.visual_changes.reshape(n, 64))
        out = to_host(out, n)
        blocked = fsm_out.blocked.cpu().numpy()
        for i, b in enumerate(self.boards):
            b.stable_move(occupancy_to_set(out.occupancy[i]), bool(blocked[i]), now,
                          self.frame_count - 1)
        return out, blocked


def final_fens(boards) -> List[str]:
    return [b.game.get_fen() for b in boards]


def commits(boards) -> List[list]:
    return [list(b.commits) for b in boards]

