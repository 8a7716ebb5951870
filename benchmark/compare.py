"""The comparison that decides ``correct``: the program's answers against
the plain reference's, on every call the program took.

``replay`` runs the reference (reference/) over the same calls: the same
frames from the bank, the same host clock for the sessions' cooldown. It
works out the calibration geometry, the plans and every state again from the
rigs' corners, and takes nothing the program made. With ``control`` it runs
the lower-precision control instead: the reference with the resample in
bfloat16, put in the program's place.

Both halves of the reference are found by name. The configuration's
``"reference"`` names the vision step, ``benchmark/reference/<module>.py``
(``pipeline`` where it names none), which exports ``IMPLEMENTS``, the
``pipeline`` settings it replays, and ``build(config, geometries, device,
resample_dtype)``: an object with ``n``, ``device``, ``init_state()``,
``capture(state, frames)`` and ``step(state, frames, s2c, given, refresh)``
-> (state, StepOutputs). The driver's ``REFERENCE`` names the session rules
over it, ``"<module>.<Class>"`` or a bare class of reference/sessions.py.
A configuration whose ``pipeline`` its reference does not implement is
refused (``unimplemented``) before a run sets anything up.

The numbers compared, each against a limit of the configuration's
``limits``:

- ``vision_mismatch_pct``: the share of (call, board, square) whose step
  outputs differ in any bool or integer field (occupancy, raw occupancy,
  visual changes, method, radius, change intensity);
- ``f32_rel_gap``: the widest gap of a float field (confidence, change
  share, change z peak, centre mean, corner mean, ring extent), as
  |program - reference| / max(1, |reference|);
- ``fsm_mismatch_pct``: where the program reports it (the N-board session's
  device noise FSM), the share of (call, board) whose ``blocked`` differs;
- ``commit_mismatches``: boards whose commits (call and move) or final FEN
  differ; an exact comparison.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import List, NamedTuple, Optional

import numpy as np

DISCRETE = ("occupancy", "raw_occupancy", "visual_changes", "method", "radius", "change_intensity")
FLOATS = ("confidence", "change_pct", "change_z_peak", "center_mean", "corner_mean",
          "profile_extent")
NAN_GAP = 1e9  # the gap where one side is NaN and the other is not
PIPELINE, RULES = "pipeline", "sessions"  # the reference modules where none is named


class Answers(NamedTuple):
    outputs: list  # a StepOutputs-like tuple a call, leaves (boards, 64) or (64,)
    blocked: Optional[np.ndarray]  # (calls, boards) or None
    commits: List[list]  # a board's [(call, uci), ...]
    fens: List[str]


def commits_of(moves_per_call: list, boards: int) -> List[list]:
    out = [[] for _ in range(boards)]
    for i, moves in enumerate(moves_per_call):
        for b, m in enumerate(moves):
            if m is not None:
                out[b].append((i, m))
    return out


def _field(outputs: list, name: str, boards: int) -> np.ndarray:
    return np.stack([np.asarray(getattr(o, name)).reshape(boards, 64) for o in outputs])


def compare(program: Answers, ref: Answers, limits: dict) -> dict:
    """{number: {"value", "limit"}}; a run is correct when no value passes its limit."""
    boards = len(ref.fens)
    n = len(ref.outputs)
    if len(program.outputs) != n:
        raise ValueError(f"the program answered {len(program.outputs)} calls, the reference {n}")
    differ = np.zeros((n, boards, 64), bool)
    for f in DISCRETE:
        differ |= _field(program.outputs, f, boards) != _field(ref.outputs, f, boards)
    gap = 0.0
    for f in FLOATS:
        p = _field(program.outputs, f, boards).astype(np.float64)
        r = _field(ref.outputs, f, boards).astype(np.float64)
        both = np.isnan(p) & np.isnan(r)
        g = np.where(both, 0.0, np.abs(p - r) / np.maximum(1.0, np.abs(r)))
        g = np.where(np.isnan(g), NAN_GAP, g)
        gap = max(gap, float(g.max(initial=0.0)))
    out = {"vision_mismatch_pct": 100.0 * float(differ.mean()), "f32_rel_gap": gap}
    if program.blocked is not None and ref.blocked is not None:
        out["fsm_mismatch_pct"] = 100.0 * float((np.asarray(program.blocked).reshape(n, boards)
                                                 != np.asarray(ref.blocked).reshape(n, boards)).mean())
    out["commit_mismatches"] = float(sum(
        pc != rc or pf != rf
        for pc, rc, pf, rf in zip(program.commits, ref.commits, program.fens, ref.fens)))
    return {k: {"value": v, "limit": float(limits[k])} for k, v in out.items()}


def load_reference(root: str, name: str):
    """``<root>/benchmark/reference/<name>.py`` as the module
    ``benchmark.reference.<name>``, so that its relative imports reach the
    frozen modules beside it; the imported module where that is the file
    the import system finds."""
    full = "benchmark.reference." + name
    path = os.path.join(root, "benchmark", "reference", name + ".py")
    found = importlib.util.find_spec(full)
    if found is not None and os.path.samefile(found.origin, path):
        return importlib.import_module(full)
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def unimplemented(config: dict, root: str) -> List[str]:
    """Each setting of the configuration's ``pipeline`` that its reference's
    ``IMPLEMENTS`` does not hold, as a line that names it; [] where none."""
    name = config.get("reference", PIPELINE)
    implements = load_reference(root, name).IMPLEMENTS
    return [f"{key} {json.dumps(value)}: reference {name} does not implement it"
            for key, value in config["pipeline"].items()
            if key not in implements or implements[key] != value]


def replay(config: dict, root: str, rules: str, corners: list, bank: list, frames,
           calls: list, device, control: bool = False) -> Answers:
    """The answers of the session rules ``rules`` (the driver's
    ``REFERENCE``) over the configuration's reference pipeline, both from
    ``<root>/benchmark/reference/``, to ``calls`` (run.Call records), on
    ``device``."""
    import torch

    from benchmark.reference.geometry import BoardGeometry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h, w = config["frame_size"]
    geometries = [BoardGeometry.from_calibration(c, display_size=(w, h)) for c in corners]
    pipe = load_reference(root, config.get("reference", PIPELINE)).build(
        config, geometries, device, torch.bfloat16 if control else torch.float32)
    module, _, cls = rules.rpartition(".")
    session = getattr(load_reference(root, module or RULES), cls)(pipe)
    # The bank on the device once: a call's frames are then gathered there.
    dev_bank = [torch.from_numpy(b).to(device) for b in bank]

    def frames_at(c: int) -> torch.Tensor:
        return torch.stack([dev_bank[b][s, r] for b, (s, r) in enumerate(frames.index(c))])

    session.capture(frames_at(0))
    outputs, blocked = [], []
    for call in calls:
        out, blk = session.call(frames_at(call.frames_at), call.now)
        outputs.append(out)
        if blk is not None:
            blocked.append(blk)
    answers = Answers(outputs, np.stack(blocked) if blocked else None,
                      [list(b.commits) for b in session.boards],
                      [b.game.get_fen() for b in session.boards])
    del dev_bank, session, pipe
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return answers
