"""Standalone enhancement demo (webcam loop).

Counterpart of chessboard_vision_tpu.tools.enhance_demo (reference
frame_enhancer.py main()): the full enhancement pipeline and the Otsu
analysis on whole camera frames, with an FPS HUD, in Original / Enhanced /
Analysis (Otsu) windows; 'q' quits. It runs the port's enhancer on
``device``: on the card the bilateral and the CLAHE's two phases are the
port's kernels (B2-B4) at the camera's frame size.

``run`` takes any camera-like reader and a ``gui``: cv2's module, or any
object with ``putText``, ``imshow``, ``waitKey``, ``destroyAllWindows``
and ``FONT_HERSHEY_SIMPLEX``. ``main`` alone imports cv2.

Run: python -m chessboard_vision_tpu_torch.tools.enhance_demo [--device cuda]
"""

from __future__ import annotations

import argparse

from chessboard_vision_tpu_torch.models.enhancer import ImageEnhancer
from chessboard_vision_tpu_torch.utils.profiling import FpsCounter


def run(cap, gui, device="cuda") -> int:
    """The demo loop over ``cap``'s frames until 'q' or the end of the
    capture, with the color profile of color_profile.json; returns the
    frames shown. ``cap`` is released and the windows destroyed on the way
    out."""
    enhancer = ImageEnhancer(load_profile_file=True, device=device)
    fps = FpsCounter()
    frames = 0
    print("enhancement demo — 'q' quits")
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            enhanced = enhancer.process_pipeline(frame)
            _, binary = enhancer.prepare_analysis(enhanced)
            fps.update()
            gui.putText(frame, f"FPS: {fps.fps:.0f}", (10, 30),
                        gui.FONT_HERSHEY_SIMPLEX, 1, (0, 255, 0), 2)
            gui.imshow("Original", frame)
            gui.imshow("Enhanced", enhanced)
            gui.imshow("Analysis (Otsu)", binary)
            frames += 1
            if gui.waitKey(1) & 0xFF == ord("q"):
                break
    finally:
        cap.release()
        gui.destroyAllWindows()
    return frames


def main(argv=None):
    import cv2

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--camera", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    args = ap.parse_args(argv)
    cap = cv2.VideoCapture(args.camera)
    if not cap.isOpened():
        print("failed to open camera")
        return 1
    run(cap, cv2, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
