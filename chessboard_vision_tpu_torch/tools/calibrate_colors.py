"""Color-profile calibrator: trackbar UI over the live camera.

Counterpart of chessboard_vision_tpu.tools.calibrate_colors (reference
calibrate_colors.py): tune the 8 color-profile parameters (hue shift,
sat/val scale, contrast, brightness, radical mode, target hue, hue window)
with a live Original | Enhanced | Gray preview and a center-pixel probe;
's' saves color_profile.json, 'q' quits. The profile is applied by the
port's own ImageEnhancer on ``device``, so what is shown is what the
enhanced pipeline computes.

``run`` takes any camera-like reader and a ``gui``: cv2's module, or any
object with the HighGUI and drawing attributes used here (``namedWindow``,
``createTrackbar``, ``getTrackbarPos``, ``imshow``, ``waitKey``,
``destroyAllWindows``, ``putText``, ``cvtColor``, ``resize`` and cv2's
constants ``FONT_HERSHEY_SIMPLEX``, ``COLOR_BGR2GRAY``, ``COLOR_GRAY2BGR``).
``main`` alone imports cv2.

Run: python -m chessboard_vision_tpu_torch.tools.calibrate_colors [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

from chessboard_vision_tpu_torch.models.enhancer import ImageEnhancer
from chessboard_vision_tpu_torch.utils.config import COLOR_PROFILE_FILE, save_json_config

WINDOW = "Color Calibration"
TRACKBARS = [
    # (name, max, to_param, from_default)
    ("Hue shift", 180, lambda v: v - 90, 90),
    ("Sat x10", 30, lambda v: v / 10.0, 10),
    ("Val x10", 30, lambda v: v / 10.0, 10),
    ("Contrast x10", 30, lambda v: v / 10.0, 10),
    ("Brightness", 200, lambda v: v - 100, 100),
    ("Radical", 1, lambda v: v, 0),
    ("Target hue", 179, lambda v: v, 0),
    ("Hue window", 90, lambda v: v, 20),
]


def profile_from_trackbars(values):
    """The color profile of the trackbars' positions, in TRACKBARS order."""
    keys = [
        "hue_shift", "sat_scale", "val_scale", "contrast",
        "brightness", "radical_mode", "target_hue", "hue_window",
    ]
    return {k: conv(v) for (name, _m, conv, _d), k, v in zip(TRACKBARS, keys, values)}


def run(cap, gui, device="cuda") -> int:
    """The preview loop over ``cap``'s frames until 'q' or the end of the
    capture; returns the frames shown. ``cap`` is released and the windows
    destroyed on the way out."""
    gui.namedWindow(WINDOW)
    for name, vmax, _conv, default in TRACKBARS:
        gui.createTrackbar(name, WINDOW, default, vmax, lambda v: None)
    print("'s' saves color_profile.json, 'q' quits")
    enhancer = ImageEnhancer(device=device)
    frames = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            profile = profile_from_trackbars(
                [gui.getTrackbarPos(name, WINDOW) for name, *_ in TRACKBARS])
            enhancer.profile = profile
            enhanced = enhancer.apply_color_profile(frame)
            gray = gui.cvtColor(enhanced, gui.COLOR_BGR2GRAY)
            h, w = frame.shape[:2]
            probe = enhanced[h // 2, w // 2]
            gui.putText(enhanced, f"probe BGR={tuple(int(x) for x in probe)}", (10, 30),
                        gui.FONT_HERSHEY_SIMPLEX, 0.6, (0, 255, 0), 2)
            triptych = np.hstack([frame, enhanced, gui.cvtColor(gray, gui.COLOR_GRAY2BGR)])
            scale = 1440 / triptych.shape[1]
            gui.imshow(WINDOW, gui.resize(triptych, None, fx=scale, fy=scale))
            frames += 1
            key = gui.waitKey(1) & 0xFF
            if key == ord("q"):
                break
            if key == ord("s"):
                save_json_config(COLOR_PROFILE_FILE, profile)
                print(f"saved {COLOR_PROFILE_FILE}: {profile}")
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
