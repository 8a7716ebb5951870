"""Process recorded footage: frames -> moves -> FEN timeline.

Counterpart of chessboard_vision_tpu.tools.process_video. The reference
only supports live cameras; this tool runs the session pipeline over
recorded footage, the way to digitize an already-filmed game.

Usage (on the card; ``--device cpu`` runs the plain PyTorch versions):
  python -m chessboard_vision_tpu_torch.tools.process_video game.mp4 \
      --calibration calibration.json --out timeline.jsonl [--pgn game.pgn]

Prints each committed move as it is detected and optionally writes a JSONL
timeline: {"frame": i, "move": "e2e4", "fen": "..."} per committed move,
then a final {"final_fen", "moves", "frames"} record. Frame skipping
matches the reference's SKIP_FRAMES=2 cadence by default.

``run_capture`` works on any source with cv2.VideoCapture's ``read()``,
``get(prop)`` and ``release()``; ``FrameReader`` is one over frames held
in memory, which is how footage reaches the card, where there is no cv2.
``run`` opens a video file and calls ``run_capture``: decoding a file
needs a codec, so ``open_video`` imports cv2, in that function alone.

``--compare-oracle`` (``compare_oracle=True``) replays the same processed
frames through the cv2 oracle's decision loop (reference/replay_session.py)
beside the session and reports their agreement: per-frame occupancy, the
move lists, the final FEN. The oracle is cv2, so the comparison runs where
cv2 is; without it the run raises an ImportError that names cv2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np

from chessboard_vision_tpu_torch.models.pipeline import occupancy_to_set
from chessboard_vision_tpu_torch.reference.replay_session import (
    OracleReplaySession,
    agreement_report,
)
from chessboard_vision_tpu_torch.session.game_session import GameSession
from chessboard_vision_tpu_torch.utils.config import load_json_config
from chessboard_vision_tpu_torch.utils.logging import get_logger

log = get_logger("process_video")

CAP_PROP_FPS = 5  # cv2.CAP_PROP_FPS


def parse_corners(text: str):
    """'x1,y1 x2,y2 x3,y3 x4,y4' -> [[x,y], ...]."""
    pts = []
    for tok in text.split():
        x, y = tok.split(",")
        pts.append([int(x), int(y)])
    if len(pts) != 4:
        raise ValueError("need exactly 4 corners")
    return pts


class FrameReader:
    """A capture over frames held in memory: cv2.VideoCapture's ``read()``,
    ``get(CAP_PROP_FPS)`` and ``release()``."""

    def __init__(self, frames: Sequence[np.ndarray], fps: float = 30.0):
        self._frames = frames
        self._fps = float(fps)
        self._next = 0

    def read(self):
        if self._next >= len(self._frames):
            return False, None
        self._next += 1
        return True, self._frames[self._next - 1]

    def get(self, prop: int) -> float:
        return self._fps if prop == CAP_PROP_FPS else 0.0

    def release(self):
        self._next = len(self._frames)


def open_video(path: str):
    """A cv2.VideoCapture of the file: the one place the port imports cv2,
    for its codecs."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    return cap


def run_capture(
    cap,
    config: dict,
    skip_frames: int = 2,
    reference_frames: int = 3,
    out_path: Optional[str] = None,
    max_frames: Optional[int] = None,
    session: Optional[GameSession] = None,
    cooldown_seconds: float = 0.0,
    device="cuda",
    compare_oracle: bool = False,
):
    """Play a capture through a GameSession; returns (moves, final_fen,
    frames_processed), or (moves, final_fen, frames_processed, report) with
    ``compare_oracle``. The capture is released at the end.

    The reference is taken from frame ``reference_frames`` (recorded
    footage is stable from frame 0); then every ``skip_frames``-th frame
    goes to ``session.on_frame``. ``cooldown_seconds`` > 0 sets the
    post-move cooldown in VIDEO time: processed frames, from the
    capture's FPS and skip_frames (wall-clock cooldowns are meaningless
    offline, where processing can run far faster than real time); 0 turns
    the cooldown off and the stability gate alone debounces. Both apply
    to the session built here on ``device`` when none is given.

    ``compare_oracle`` replays the same frames through the cv2 oracle's
    decision loop (OracleReplaySession, the same gates and cooldown) and
    returns its agreement report (``agreement_report``: per-frame occupancy
    agreement, move-list diff, FEN match), also written to the timeline as
    a last {"oracle_comparison": report} record. Its keys are the JAX
    tool's (``tpu_moves``, ``tpu_final_fen``, ...): they are the file
    format."""
    try:
        cooldown_frames = None
        if cooldown_seconds > 0:
            fps = cap.get(CAP_PROP_FPS) or 30.0
            cooldown_frames = max(1, int(cooldown_seconds * fps / max(skip_frames, 1)))
        if session is None:
            session = GameSession(device=device)
            if cooldown_frames is not None:
                session.cooldown_frames = cooldown_frames
            else:
                session.MOVE_COOLDOWN = 0.0
        if not session.on_calibration_requested(config=config):
            raise ValueError("calibration config rejected (missing corners?)")
        oracle, per_frame_matches = None, []
        if compare_oracle:
            oracle = OracleReplaySession(config, cooldown_frames=cooldown_frames)

        ref = None
        for _ in range(max(reference_frames, 1)):
            ok, img = cap.read()
            if not ok:
                raise ValueError("video ended before a reference frame was read")
            ref = img
        session.capture_reference_frame(ref)
        if oracle is not None:
            oracle.capture_reference(ref)

        moves = []
        i = processed = 0
        with open(out_path or os.devnull, "w") as out_f:
            while True:
                ok, img = cap.read()
                if not ok:
                    break
                i += 1
                if skip_frames > 1 and i % skip_frames:
                    continue
                processed += 1
                move = session.on_frame(img)
                if oracle is not None:
                    omove = oracle.on_frame(img)
                    if omove is not None:
                        log.info("frame %d: oracle committed %s", i, omove.uci())
                    occ = occupancy_to_set(session.last_outputs.occupancy)
                    per_frame_matches.append(64 - len(occ ^ oracle.last_occupancy))
                if move is not None:
                    moves.append(move.uci())
                    fen = session.game.get_fen()
                    log.info("frame %d: %s -> %s", i, move.uci(), fen)
                    print(f"[{i}] {move.uci()}  {fen}")
                    out_f.write(json.dumps({"frame": i, "move": move.uci(), "fen": fen}) + "\n")
                if max_frames and processed >= max_frames:
                    break
            final_fen = session.game.get_fen()
            out_f.write(json.dumps({"final_fen": final_fen, "moves": moves,
                                    "frames": processed}) + "\n")
            if oracle is not None:
                report = agreement_report(moves, final_fen, oracle, per_frame_matches)
                out_f.write(json.dumps({"oracle_comparison": report}) + "\n")
                return moves, final_fen, processed, report
        return moves, final_fen, processed
    finally:
        cap.release()


def run(
    video_path: str,
    config: dict,
    skip_frames: int = 2,
    reference_frames: int = 3,
    out_path: Optional[str] = None,
    max_frames: Optional[int] = None,
    session: Optional[GameSession] = None,
    cooldown_seconds: float = 0.0,
    compare_oracle: bool = False,
    device="cuda",
):
    """Process the video file: run_capture on the decoded file; returns
    (moves, final_fen, frames_processed), with the oracle's agreement report
    as a fourth item when ``compare_oracle``."""
    return run_capture(
        open_video(video_path), config, skip_frames=skip_frames,
        reference_frames=reference_frames, out_path=out_path, max_frames=max_frames,
        session=session, cooldown_seconds=cooldown_seconds, device=device,
        compare_oracle=compare_oracle,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("video", help="video file path (any OpenCV-readable format)")
    ap.add_argument("--calibration", default="calibration.json",
                    help="calibration JSON (corners etc.)")
    ap.add_argument("--corners", default=None,
                    help="override: 'x1,y1 x2,y2 x3,y3 x4,y4' (TL TR BL BR)")
    ap.add_argument("--skip-frames", type=int, default=2,
                    help="process every Nth frame (reference SKIP_FRAMES)")
    ap.add_argument("--out", default=None, help="JSONL timeline output path")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--pgn", default=None, metavar="FILE",
                    help="write the digitized game as PGN")
    ap.add_argument("--cooldown-seconds", type=float, default=0.0,
                    help="post-move cooldown in VIDEO seconds (converted to processed "
                    "frames via the file's FPS). 0 = no cooldown (default: the "
                    "20-frame stability gate alone debounces)")
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    ap.add_argument("--auto-recalibrate", action="store_true",
                    help="detect mid-footage camera bumps and rebuild geometry "
                    "(session/drift.py)")
    ap.add_argument("--compare-oracle", action="store_true",
                    help="also replay the video through the cv2 oracle decision loop and "
                    "print a decision-agreement report (per-frame occupancy agreement, "
                    "move-list diff, FEN match); needs cv2")
    args = ap.parse_args(argv)

    if args.corners:
        config = {
            "corners": parse_corners(args.corners),
            "player_color": "white",
            "orientation_flipped": False,
            "grid_lines_x": None,
            "grid_lines_y": None,
        }
    else:
        config = load_json_config(args.calibration)
        if config is None:
            print(f"no calibration at {args.calibration}; pass --corners", file=sys.stderr)
            return 2

    if args.auto_recalibrate:
        config = {**config, "auto_recalibrate": True}
    result = run(
        args.video, config, skip_frames=args.skip_frames, out_path=args.out,
        max_frames=args.max_frames, cooldown_seconds=args.cooldown_seconds,
        compare_oracle=args.compare_oracle, device=args.device,
    )
    moves, fen, n = result[:3]
    print(f"\n{len(moves)} moves over {n} processed frames")
    print(f"final FEN: {fen}")
    if args.compare_oracle:
        report = result[3]
        print("\noracle comparison (cv2 decision loop on the same frames):")
        print(f"  per-square occupancy agreement: {report['square_agreement_pct']}%")
        print(f"  frames fully agreeing:          {report['frame_full_agreement_pct']}%")
        print(f"  move lists match: {report['move_lists_match']} "
              f"(tpu {len(report['tpu_moves'])} vs oracle {len(report['oracle_moves'])} moves"
              + (f"; first divergence at move index {report['first_divergent_move']}"
                 if report["first_divergent_move"] is not None else "")
              + ")")
        print(f"  final FEN match: {report['fen_match']}")
        if not report["fen_match"]:
            print(f"    tpu:    {report['tpu_final_fen']}")
            print(f"    oracle: {report['oracle_final_fen']}")
    if args.pgn:
        from chessboard_vision_tpu_torch.rules.pgn import game_to_pgn

        with open(args.pgn, "w") as f:
            f.write(game_to_pgn(moves, headers={"Event": "digitized recording"},
                                claim_draws=True))  # the clip is the whole game
        print(f"PGN written to {args.pgn}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
