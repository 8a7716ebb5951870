"""Headless end-to-end demo: synthetic camera clip -> moves -> FEN.

Renders a scripted game as perspective-projected frames (tools/synth.py),
runs the port's GameSession.on_frame over them on the chosen device, and
prints each committed move, the final FEN and the PGN. Exits 1 if a
scripted move is not committed or the FEN differs from the script's.

Run: python -m chessboard_vision_tpu_torch.tools.demo_pipeline [--enhance]
(on the card, with the conv Hough backend; ``--device cpu`` runs the plain
PyTorch versions instead, with the exact Hough backend).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from chessboard_vision_tpu_torch.rules import chess
from chessboard_vision_tpu_torch.session.game_session import GameSession
from chessboard_vision_tpu_torch.tools.synth import SynthCamera

CORNERS = [[260, 80], [1020, 95], [240, 640], [1035, 655]]


def occupancy_of(board) -> np.ndarray:
    """(8, 8) [file, rank] occupancy of a rules board."""
    occ = np.zeros((8, 8), bool)
    for sq in chess.SQUARES:
        if board.piece_at(sq) is not None:
            occ[chess.square_file(sq), chess.square_rank(sq)] = True
    return occ


def calibrated_session(corners, display_size=None, device="cuda",
                       use_enhancer=False, hough_backend="auto") -> GameSession:
    """A GameSession on ``device`` calibrated from four board corners (TL,
    TR, BL, BR) of a ``display_size`` (width, height) frame, or of the
    default 1280x720 when None, with the move cooldown off for replay.
    ``use_enhancer`` runs the enhanced pipeline (config "use_enhancer");
    ``hough_backend`` goes to the pipeline ("auto": exact on the CPU, conv
    on the card)."""
    session = GameSession(device=device, hough_backend=hough_backend)
    session.MOVE_COOLDOWN = 0.0
    config = {
        "corners": np.asarray(corners).tolist(),
        "player_color": "white",
        "orientation_flipped": False,
        "grid_lines_x": None,
        "grid_lines_y": None,
        "use_enhancer": use_enhancer,
    }
    if display_size is not None:
        config["display_size"] = list(display_size)
    if not session.on_calibration_requested(config=config):
        raise RuntimeError("calibration failed")
    return session


def play(session: GameSession, camera: SynthCamera, moves, rng,
         frames_per_position: int = 26, log=print):
    """Drive ``session`` through the scripted UCI ``moves``. Returns
    (committed moves, script board, frames rendered); stops at the first
    scripted move that is not committed (so fewer moves come back)."""
    script = chess.Board()
    session.capture_reference_frame(camera.render(occupancy_of(script), rng))
    committed, n_frames = [], 0
    for uci in moves:
        script.push_uci(uci)
        occ = occupancy_of(script)
        got = None
        for _ in range(frames_per_position + 15):
            n_frames += 1
            got = session.on_frame(camera.render(occ, rng))
            if got:
                break
        if got is None:
            log(f"FAILED to detect scripted move {uci}")
            break
        committed.append(got.uci())
        log(f"detected + committed: {got.uci()}")
        if got.uci() != uci:
            log(f"MISMATCH: scripted {uci}")
            break
    return committed, script, n_frames


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--moves", default="e2e4 e7e5 g1f3 b8c6", help="scripted UCI moves")
    ap.add_argument("--frames-per-position", type=int, default=26)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    ap.add_argument("--enhance", action="store_true",
                    help="run the enhanced pipeline (CLAHE, bilateral, sharpen, normalize)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")

    rng = np.random.default_rng(args.seed)
    session = calibrated_session(CORNERS, device=args.device, use_enhancer=args.enhance)
    camera = SynthCamera(CORNERS)

    moves = args.moves.split()
    t0 = time.time()
    committed, script, n_frames = play(
        session, camera, moves, rng, args.frames_per_position
    )
    dt = time.time() - t0
    if committed != moves:
        print(f"session FEN: {session.game.get_fen()}")
        return 1
    print(f"\nall {len(committed)} scripted moves detected correctly")
    print(f"final FEN: {session.game.get_fen()}")
    print(f"script FEN: {script.fen()}")
    print(f"{n_frames} frames in {dt:.1f}s ({n_frames / dt:.1f} fps incl. render) "
          f"on {args.device}, hough_backend {session.pipeline.hough_backend}")
    print("\nPGN:\n" + session.to_pgn(headers={"Event": "demo_pipeline"}))
    if session.game.get_fen() != script.fen():
        print("FEN MISMATCH")
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
