"""Play on Lichess from a physical board (the live driver).

Counterpart of chessboard_vision_tpu.tools.play_lichess (reference
play_lichess.py): camera at 1280x720, calibration, Lichess connect, then
the frame loop. Capture runs on its own thread through the SPSC frame ring
(native.FrameRing, drop-oldest), which decouples camera jitter from the
step; ``--no-ring`` polls the camera inline instead, every SKIP_FRAMES-th
frame. The ring is built with g++ at first use, and a failed build raises:
the JAX driver falls back to inline polling in silence, the port only when
asked to. Keys: 'q' quits, 'c' re-captures the visual reference, 'k' saves
a session checkpoint.

The frame loop, ``run``, takes any capture-like reader (``read()``,
``release()``) and any key source (``wait_key(ms) -> int``, cv2.waitKey's
contract): ``main`` passes the camera and HighGUI of cv2, which it alone
imports, and builds the session with ``headless=False``, so the board
overlay shows in the "Board" window as in the JAX play_lichess; tests and
chip_smoke.py drive the loop from frames in memory with a fake client.

Run: python -m chessboard_vision_tpu_torch.tools.play_lichess [--auto-recalibrate]
"""

from __future__ import annotations

import argparse
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np

from chessboard_vision_tpu_torch.native import FrameRing
from chessboard_vision_tpu_torch.session.lichess_session import LichessSession
from chessboard_vision_tpu_torch.utils.logging import get_logger

CAMERA_ID = 0
WIDTH, HEIGHT = 1280, 720
SKIP_FRAMES = 2

log = get_logger("play_lichess")


class LoopResult(NamedTuple):
    frames: int  # frames handed to session.on_frame
    dropped: int  # frames the capture thread overwrote before they were read (ring only)
    skipped: int  # frames the loop passed over to step the newest (ring only)


def _capture_loop(cap, ring: FrameRing, stop: threading.Event):
    """The capture thread: camera frames into the ring until ``stop``."""
    warned = False
    while not stop.is_set():
        ok, img = cap.read()
        if not ok:
            stop.wait(0.01)  # a camera that fails returns at once: do not spin
            continue
        if img.shape != ring.shape:
            if not warned:
                log.warning("camera delivers %s, expected %s; frames dropped: use --no-ring "
                            "or fix the camera mode", img.shape, ring.shape)
                warned = True
            continue
        ring.push(img)


def run(session: LichessSession, cap, wait_key: Callable[[int], int],
        show: Optional[Callable[[str, np.ndarray], None]] = None, use_ring: bool = True,
        checkpoint: str = "session_checkpoint.npz", pgn: Optional[str] = None) -> LoopResult:
    """The frame loop of a calibrated, connected session, until 'q', the end
    of the game (``session.stop_event``) or, polling inline, the end of the
    capture. With ``use_ring`` a capture thread pushes ``cap``'s
    HEIGHT x WIDTH frames into a 4-slot FrameRing and the loop takes the
    newest; without, it
    reads ``cap`` itself and steps every SKIP_FRAMES-th frame (``show``,
    when given, displays the others). On the way out: the capture thread
    stopped, the PGN written to ``pgn``, ``session.on_exit()``, ``cap``
    released."""
    ring = FrameRing((HEIGHT, WIDTH, 3), n_slots=4) if use_ring else None
    stop = threading.Event()
    capture_thread = None
    if ring is not None:
        capture_thread = threading.Thread(target=_capture_loop, args=(cap, ring, stop),
                                          daemon=True)
        capture_thread.start()
    frame_count = processed = dropped = skipped = 0
    try:
        while not session.stop_event.is_set():
            if ring is not None:
                skipped += ring.skip_to_latest()
                seq, img = ring.pop()
                if not seq:
                    # Keep the key source polled while the ring is empty: a
                    # dead capture thread must not make the loop unkillable.
                    if wait_key(15) & 0xFF == ord("q"):
                        break
                    continue
            else:
                ok, img = cap.read()
                if not ok:
                    break
                frame_count += 1
                if SKIP_FRAMES > 1 and frame_count % SKIP_FRAMES != 0:
                    if show is not None:
                        show("Camera", img)
                    if wait_key(1) & 0xFF == ord("q"):
                        break
                    continue

            session.on_frame(img)
            processed += 1
            key = wait_key(1) & 0xFF
            if key == ord("q"):
                break
            if key == ord("c"):
                print("[re-reference]")
                session.capture_reference_frame(img)
            if key == ord("k"):
                session.save_checkpoint(checkpoint)
                print(f"[checkpoint] {checkpoint}")
    finally:
        stop.set()
        if capture_thread is not None:
            # cap.read() and cap.release() racing is not thread-safe: let
            # the capture thread see the stop first.
            capture_thread.join(timeout=2.0)
        if ring is not None:
            dropped = ring.dropped
        if pgn and session.game is not None:
            try:
                with open(pgn, "w") as f:
                    f.write(session.to_pgn())
                print(f"[pgn] {pgn}")
            except OSError as e:  # never mask the shutdown path
                print(f"[pgn] export failed: {e}")
        session.on_exit()
        cap.release()
        if ring is not None:
            ring.close()
    return LoopResult(processed, dropped, skipped)


def main(argv=None):
    import cv2

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--camera", type=int, default=CAMERA_ID)
    ap.add_argument("--no-ring", action="store_true", help="poll camera inline")
    ap.add_argument("--resume", default=None, metavar="CKPT",
                    help="resume a session checkpoint (skips calibration + "
                    "reference capture)")
    ap.add_argument("--checkpoint", default="session_checkpoint.npz",
                    metavar="CKPT", help="path the 'k' key saves to")
    ap.add_argument("--pgn", default=None, metavar="FILE",
                    help="write the game as PGN on exit")
    ap.add_argument("--auto-recalibrate", action="store_true",
                    help="detect camera bumps (periodic corner "
                    "re-detection) and rebuild geometry mid-game "
                    "(session/drift.py); same as \"auto_recalibrate\": "
                    "true in calibration.json")
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    args = ap.parse_args(argv)

    cap = cv2.VideoCapture(args.camera)
    cap.set(3, WIDTH)
    cap.set(4, HEIGHT)
    if not cap.isOpened():
        print("failed to open camera")
        return 1

    session = LichessSession(device=args.device, headless=False)
    if args.auto_recalibrate:
        session.default_config_overrides = {"auto_recalibrate": True}
    if args.resume:
        session.resume_checkpoint(args.resume)
        print(f"resumed from {args.resume}: {session.game.get_fen()}")
    elif not session.on_calibration_requested(cap, gui=cv2):
        print("calibration cancelled")
        cap.release()
        return 1
    if not session.connect_and_setup():
        cap.release()
        return 1

    print(f"playing as: {session.my_color or 'awaiting stream...'}")
    print("'q' quits, 'c' re-captures the visual reference, "
          f"'k' checkpoints to {args.checkpoint}\n")
    try:
        run(session, cap, cv2.waitKey, show=cv2.imshow, use_ring=not args.no_ring,
            checkpoint=args.checkpoint, pgn=args.pgn)
    finally:
        cv2.destroyAllWindows()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
