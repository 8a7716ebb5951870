# Frozen copy of chessboard_vision_tpu_torch/ops/fsm.py at commit 9f9af32, for the
# benchmark's plain reference: imports rewritten to this folder, nothing else
# changed unless a "reference:" comment says so.
"""Device-side noise FSM: the NoiseHandler as branchless tensor ops.

Counterpart of chessboard_vision_tpu.ops.fsm. The per-stream hand-occlusion
state machine (session/noise.py, reference noise_handler.py) runs on the
device so an N-stream tick needs no host round trip before its FSM: the
state is a few tensors per stream and the transition is ``torch.where``
selects. Every field may carry leading axes: ``(64,)`` squares and ``()``
scalars for one stream, ``(N, 64)`` and ``(N,)`` for N streams, stepped
at once (the JAX package vmaps the one-stream function instead).
Semantics match NoiseHandler exactly (same thresholds and transitions).

Modes: 0 = IDLE, 1 = NOISE_ACTIVE, 2 = MOVE_PENDING.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

MODE_IDLE, MODE_NOISE, MODE_PENDING = 0, 1, 2

NOISE_THRESHOLD = 3
STABILITY_FRAMES = 12
COOLDOWN_FRAMES = 5


class NoiseFsmState(NamedTuple):
    mode: torch.Tensor  # (...) i32
    pending: torch.Tensor  # (..., 64) bool
    stable_count: torch.Tensor  # (...) i32
    cooldown: torch.Tensor  # (...) i32
    lifted: torch.Tensor  # (...) i32 square index or -1


class NoiseFsmOut(NamedTuple):
    mode: torch.Tensor  # (...) i32 (post-transition)
    stable: torch.Tensor  # (...) bool: stable_ready / move_ready fired
    move_ready: torch.Tensor  # (...) bool: pending squares cleared + stable
    squares: torch.Tensor  # (..., 64) bool pending squares at fire time
    lifted: torch.Tensor  # (...) i32
    blocked: torch.Tensor  # (...) bool: mode == NOISE_ACTIVE


def init_state(n: Optional[int] = None, device="cuda") -> NoiseFsmState:
    """The IDLE state of one stream (``n`` None: scalars and (64,)) or of
    ``n`` streams ((n,) and (n, 64))."""
    lead = () if n is None else (n,)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return NoiseFsmState(
        mode=full(lead, MODE_IDLE, torch.int32),
        pending=full(lead + (64,), False, torch.bool),
        stable_count=full(lead, 0, torch.int32),
        cooldown=full(lead, 0, torch.int32),
        lifted=full(lead, -1, torch.int32),
    )


def _first_set_index(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first set square along the last axis, -1 if none."""
    idx = torch.argmax(mask.to(torch.int32), dim=-1).to(torch.int32)  # first max on ties
    return torch.where(mask.any(dim=-1), idx, -1).to(torch.int32)


def noise_step(state: NoiseFsmState, changed: torch.Tensor):
    """One FSM transition. changed: (..., 64) bool. Returns (state, out)."""
    i32 = torch.int32
    n = changed.sum(dim=-1, dtype=i32)
    mode = state.mode
    same_as_pending = (changed == state.pending).all(dim=-1)
    lifted_new = _first_set_index(changed)

    # --- IDLE transitions
    idle_to_noise = (mode == MODE_IDLE) & (n > NOISE_THRESHOLD)
    idle_to_pending = (mode == MODE_IDLE) & (n > 0) & (n <= NOISE_THRESHOLD)

    # --- NOISE transitions
    in_noise = mode == MODE_NOISE
    noise_zero = in_noise & (n == 0)
    noise_low = in_noise & (n > 0) & (n <= NOISE_THRESHOLD)
    noise_high = in_noise & (n > NOISE_THRESHOLD)
    cooldown_after = torch.where(
        noise_zero | noise_low, state.cooldown + 1,
        torch.where(noise_high, 0, state.cooldown),
    )
    noise_to_idle = noise_zero & (cooldown_after >= COOLDOWN_FRAMES)
    noise_to_pending = noise_low & (cooldown_after >= COOLDOWN_FRAMES)

    # --- PENDING transitions
    in_pending = mode == MODE_PENDING
    pend_to_noise = in_pending & (n > NOISE_THRESHOLD)
    pend_zero = in_pending & (n == 0)
    low = in_pending & (n > 0) & (n <= NOISE_THRESHOLD)
    pend_same = low & same_as_pending
    pend_update = low & ~same_as_pending

    enter_or_update = idle_to_pending | noise_to_pending | pend_update
    stable_after = torch.where(
        pend_zero | pend_same, state.stable_count + 1,
        torch.where(enter_or_update, 1, state.stable_count),
    )
    move_ready = pend_zero & (stable_after >= STABILITY_FRAMES)
    stable_ready = pend_same & (stable_after >= STABILITY_FRAMES)
    fired = move_ready | stable_ready

    # --- next mode
    next_mode = torch.where(
        idle_to_noise | noise_high | pend_to_noise,
        MODE_NOISE,
        torch.where(
            enter_or_update | pend_same | (pend_zero & ~move_ready),
            MODE_PENDING,
            torch.where(
                noise_to_idle | move_ready,
                MODE_IDLE,
                torch.where(noise_zero | noise_low, MODE_NOISE, mode),
            ),
        ),
    ).to(i32)

    # Per-stream flags select whole (..., 64) square masks.
    next_pending = torch.where(
        enter_or_update[..., None],
        changed,
        torch.where(move_ready[..., None], False, state.pending),
    )
    # move_ready and stable_ready report the pre-transition pending set.
    out_squares = torch.where(fired[..., None], state.pending, next_pending)

    # noise_to_pending refreshes the lifted square for the NEW pending
    # cycle, matching the host FSM (session/noise.py _noise).
    next_lifted = torch.where(
        enter_or_update & (n == 1),
        lifted_new,
        torch.where(enter_or_update | move_ready, -1, state.lifted),
    ).to(i32)

    next_stable = torch.where(
        move_ready | idle_to_noise | pend_to_noise, 0, stable_after
    ).to(i32)
    next_cooldown = torch.where(
        noise_to_idle | noise_to_pending | move_ready | idle_to_noise | pend_to_noise,
        0,
        torch.where(in_noise, cooldown_after, state.cooldown),
    ).to(i32)

    new_state = NoiseFsmState(
        mode=next_mode,
        pending=next_pending,
        stable_count=next_stable,
        cooldown=next_cooldown,
        lifted=next_lifted,
    )
    out = NoiseFsmOut(
        mode=next_mode,
        stable=fired,
        move_ready=move_ready,
        squares=out_squares,
        lifted=next_lifted,
        blocked=next_mode == MODE_NOISE,
    )
    return new_state, out
