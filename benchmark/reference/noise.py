# Frozen copy of chessboard_vision_tpu_torch/session/noise.py at commit 9f9af32, for the
# benchmark's plain reference: imports rewritten to this folder, nothing else
# changed unless a "reference:" comment says so.
"""Noise-handling state machine (hand occlusion / move stabilization).

Behavioral equivalent of reference noise_handler.py: a 3-state FSM over the
per-frame set of visually-changed squares. IDLE -> (>3 changes) ->
NOISE_ACTIVE -> (5 clean frames) -> IDLE; IDLE -> (1..3 changes) ->
MOVE_PENDING -> (12 stable frames) -> move_ready/stable_ready. Tracks the
'lifted' square when exactly one change is pending.

Each frame's square set is classified into one of three EVENTS
(EMPTY / FEW / MANY) and a (state, event) dispatch table routes to a small
handler. The payload contract (message strings + keys) is the JAX
package's session/noise.py, of which this is a verbatim port.
"""

from __future__ import annotations

from enum import Enum, auto


class NoiseState(Enum):
    IDLE = auto()
    NOISE_ACTIVE = auto()
    MOVE_PENDING = auto()


class _Event(Enum):
    EMPTY = auto()  # no changed squares
    FEW = auto()  # 1..NOISE_THRESHOLD changes (a candidate move)
    MANY = auto()  # > NOISE_THRESHOLD changes (a hand / occlusion)


class NoiseHandler:
    NOISE_THRESHOLD = 3
    STABILITY_FRAMES = 12
    COOLDOWN_FRAMES = 5

    def __init__(self):
        self._dispatch = {
            (NoiseState.IDLE, _Event.EMPTY): self._idle_wait,
            (NoiseState.IDLE, _Event.FEW): self._begin_pending,
            (NoiseState.IDLE, _Event.MANY): self._begin_noise,
            (NoiseState.NOISE_ACTIVE, _Event.EMPTY): self._cooldown_toward_idle,
            (NoiseState.NOISE_ACTIVE, _Event.FEW): self._cooldown_toward_pending,
            (NoiseState.NOISE_ACTIVE, _Event.MANY): self._hand_still_there,
            (NoiseState.MOVE_PENDING, _Event.EMPTY): self._count_toward_move,
            (NoiseState.MOVE_PENDING, _Event.FEW): self._track_pending,
            (NoiseState.MOVE_PENDING, _Event.MANY): self._hand_interrupts,
        }
        self.reset()

    # -- public API ------------------------------------------------------

    def process(self, changed_squares: set) -> tuple:
        """Advance one frame; returns (state, payload)."""
        n = len(changed_squares)
        if n == 0:
            ev = _Event.EMPTY
        elif n <= self.NOISE_THRESHOLD:
            ev = _Event.FEW
        else:
            ev = _Event.MANY
        return self._dispatch[(self.state, ev)](changed_squares)

    def reset(self):
        self.state = NoiseState.IDLE
        self.pending_squares: set = set()
        self.stable_count = 0
        self.cooldown_count = 0
        self.last_lifted_square = None

    def is_blocked(self) -> bool:
        return self.state == NoiseState.NOISE_ACTIVE

    def get_state_name(self) -> str:
        return {
            NoiseState.IDLE: "IDLE",
            NoiseState.NOISE_ACTIVE: "NOISE",
            NoiseState.MOVE_PENDING: "PENDING",
        }.get(self.state, "UNKNOWN")

    # -- shared transition helpers --------------------------------------

    def _take_pending(self, squares: set) -> None:
        """Adopt ``squares`` as the pending-move candidate set (stability
        counting restarts; the 'lifted' square is meaningful only for a
        single-square candidate — and is refreshed here so a stale one
        from a previous cycle never leaks into later payloads)."""
        self.state = NoiseState.MOVE_PENDING
        self.pending_squares = set(squares)
        self.stable_count = 1
        self.last_lifted_square = (
            next(iter(squares)) if len(squares) == 1 else None
        )

    def _pending_payload(self, message: str, **extra) -> tuple:
        out = {
            "message": message,
            "squares": self.pending_squares,
            "stable": False,
            "progress": self.stable_count / self.STABILITY_FRAMES,
        }
        out.update(extra)
        return (NoiseState.MOVE_PENDING, out)

    # -- IDLE ------------------------------------------------------------

    def _idle_wait(self, _squares):
        return (NoiseState.IDLE, {"message": "waiting"})

    def _begin_noise(self, squares):
        self.state = NoiseState.NOISE_ACTIVE
        self.cooldown_count = 0
        return (
            NoiseState.NOISE_ACTIVE,
            {"message": "hand_detected", "changed_count": len(squares)},
        )

    def _begin_pending(self, squares):
        self._take_pending(squares)
        return self._pending_payload("detecting", lifted=self.last_lifted_square)

    # -- NOISE_ACTIVE ----------------------------------------------------

    def _cooldown_toward_idle(self, _squares):
        self.cooldown_count += 1
        if self.cooldown_count >= self.COOLDOWN_FRAMES:
            self.state = NoiseState.IDLE
            self.cooldown_count = 0
            return (NoiseState.IDLE, {"message": "noise_cleared"})
        return (
            NoiseState.NOISE_ACTIVE,
            {
                "message": "clearing",
                "cooldown": self.cooldown_count,
                "progress": self.cooldown_count / self.COOLDOWN_FRAMES,
            },
        )

    def _cooldown_toward_pending(self, squares):
        self.cooldown_count += 1
        if self.cooldown_count >= self.COOLDOWN_FRAMES:
            self._take_pending(squares)
            # the reference emits the short payload on this edge (no
            # lifted/progress keys) — part of the parity contract
            return (
                NoiseState.MOVE_PENDING,
                {
                    "message": "detecting",
                    "squares": self.pending_squares,
                    "stable": False,
                },
            )
        return (
            NoiseState.NOISE_ACTIVE,
            {"message": "stabilizing", "changed_count": len(squares)},
        )

    def _hand_still_there(self, squares):
        self.cooldown_count = 0
        return (
            NoiseState.NOISE_ACTIVE,
            {"message": "hand_active", "changed_count": len(squares)},
        )

    # -- MOVE_PENDING ----------------------------------------------------

    def _hand_interrupts(self, squares):
        self.state = NoiseState.NOISE_ACTIVE
        self.pending_squares = set()
        self.stable_count = 0
        self.cooldown_count = 0
        # last_lifted_square is deliberately RETAINED across the
        # interruption (parity with the device FSM, asserted every step
        # by the differential test); every later MOVE_PENDING entry
        # refreshes it before any payload can read it.
        return (
            NoiseState.NOISE_ACTIVE,
            {"message": "interrupted_by_hand", "changed_count": len(squares)},
        )

    def _count_toward_move(self, _squares):
        self.stable_count += 1
        if self.stable_count >= self.STABILITY_FRAMES:
            squares = set(self.pending_squares)
            self.reset()
            return (
                NoiseState.IDLE,
                {"message": "move_ready", "squares": squares, "stable": True},
            )
        return self._pending_payload("stabilizing")

    def _track_pending(self, squares):
        if squares != self.pending_squares:
            self._take_pending(squares)
            return self._pending_payload("updated", lifted=self.last_lifted_square)
        self.stable_count += 1
        if self.stable_count >= self.STABILITY_FRAMES:
            return (
                NoiseState.MOVE_PENDING,
                {
                    "message": "stable_ready",
                    "squares": set(self.pending_squares),
                    "stable": True,
                    "progress": 1.0,
                },
            )
        return self._pending_payload(
            "counting",
            lifted=(
                self.last_lifted_square
                if len(self.pending_squares) == 1
                else None
            ),
        )
