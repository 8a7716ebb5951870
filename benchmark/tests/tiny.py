"""Small cells of the benchmark's own configurations and mixes, for the CPU
tests: 320x240 frames, a few boards, short move periods."""

from __future__ import annotations

import json
import os

from benchmark import run

ROOT = run.ROOT
SEED = 2**31 + 4321  # a seed past 32 signed bits, as the benchmark's seeds are
SIZES = {"frame_size": [240, 320], "board_jitter_px": 8}
MIX = {"warmup_calls": 5, "first_move_after": 5, "move_every": 40, "hand_calls": 6}


def cell(config: str, traffic: str, boards: int = None, **mix) -> run.Cell:
    with open(os.path.join(ROOT, "benchmark", "configs", config + ".json")) as fh:
        cfg = dict(json.load(fh), **SIZES)
    if boards is not None:
        cfg["boards"] = boards
    with open(os.path.join(ROOT, "benchmark", "traffic", traffic + ".json")) as fh:
        tr = dict(json.load(fh), **MIX, **mix)
    e2e = [{"name": n, "unit": "-"} for n in ("frame_p95_ms", "frame_p50_ms", "frames_per_s",
                                             "setup_s")]
    return run.Cell(ROOT, f"{config}.{traffic}", cfg, tr, 1, e2e, [])


def player(**mix) -> run.Cell:
    return cell("player_720p", "live30", rate_hz=15, **mix)


def hall(boards: int = 2, **mix) -> run.Cell:
    return cell("hall_1080p", "capacity", boards=boards, stagger=10, max_moves=2, **mix)


def run_cpu(c: run.Cell, seconds: float = 3.0, seed: int = SEED, control: bool = False) -> dict:
    import time

    return run.run_cell(c, seed, seconds, False, device="cpu", t_start=time.perf_counter(),
                        control=control)[0]
