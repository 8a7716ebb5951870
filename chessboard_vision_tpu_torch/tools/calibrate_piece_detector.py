"""Piece-detector calibrator (trackbar UI) + stats export.

Counterpart of chessboard_vision_tpu.tools.calibrate_piece_detector
(reference calibrate_piece_detector.py:139-335): tune the Hough radius
percentages, param1/param2 and the center-diff threshold over the live
warped board, each detection drawn in its method's color; 's' saves
piece_detector_settings.json, 'e' exports piece_stats.txt, 'q' quits. As in
the reference tool, the live tuning sets the detector's thresholds directly
(``VisionPipeline(detector_overrides=...)``); the runtime loader honors
only the saved min/max radius (the reference quirk, piece_detector.py:58-65).

``run`` takes any camera-like reader and a ``gui``: cv2's module, or any
object with the HighGUI and drawing attributes used here (``namedWindow``,
``createTrackbar``, ``getTrackbarPos``, ``imshow``, ``waitKey``,
``destroyAllWindows``, ``circle``, ``putText``, ``FONT_HERSHEY_SIMPLEX``).
``main`` alone imports cv2 and passes it in.

Run: python -m chessboard_vision_tpu_torch.tools.calibrate_piece_detector [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

from chessboard_vision_tpu_torch import geometry as geo
from chessboard_vision_tpu_torch.models.pipeline import VisionPipeline, outputs_to_numpy
from chessboard_vision_tpu_torch.ops.piece import METHOD_NAMES
from chessboard_vision_tpu_torch.utils.config import (
    CALIBRATION_FILE,
    PIECE_SETTINGS_FILE,
    load_json_config,
    save_json_config,
)

WINDOW = "Piece Detector"
METHOD_COLORS = {
    1: (0, 255, 0),      # hough
    2: (255, 200, 0),    # tower_top
    3: (0, 200, 255),    # center_diff
    4: (255, 0, 255),    # symmetry
}
# Frames the sliders must stay still before the pipeline is rebuilt: a
# rebuild (plan build and reference capture) on every notch of a drag
# would stall the UI, and which frames rebuild decides every later image.
REBUILD_STILL_FRAMES = 15


def export_stats(path, out, settings):
    """Write the occupied squares' radius, method and confidence of one
    step's host outputs to ``path``."""
    import datetime

    radius = np.asarray(out.radius)
    method = np.asarray(out.method)
    conf = np.asarray(out.confidence)
    # Raw occupancy: method, radius and confidence describe this frame's
    # detection; a square held by smoothing would export "method=None r=0px".
    has = np.asarray(out.raw_occupancy)
    lines = [
        f"piece detector stats — {datetime.datetime.now():%Y-%m-%d %H:%M}",
        f"settings: {settings}",
        f"occupied: {int(has.sum())}/64",
    ]
    for s in range(64):
        if has[s]:
            f, r = s % 8, s // 8
            lines.append(
                f"  {'abcdefgh'[f]}{r + 1}: r={int(radius[s])}px "
                f"method={METHOD_NAMES[int(method[s])]} conf={conf[s]:.2f}"
            )
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"exported {path}")


def run(cap, gui, config: dict, device="cuda") -> int:
    """The tuning loop over ``cap``'s frames until 'q' or the end of the
    capture; returns the frames shown. The pipeline is rebuilt on
    ``device`` with the sliders' settings once they have been still for
    REBUILD_STILL_FRAMES frames. ``cap`` is released and the windows
    destroyed on the way out."""
    gui.namedWindow(WINDOW)
    saved = load_json_config(PIECE_SETTINGS_FILE, {}) or {}
    gui.createTrackbar("Min radius %", WINDOW, int(saved.get("min_radius", 20)), 50, lambda v: None)
    gui.createTrackbar("Max radius %", WINDOW, int(saved.get("max_radius", 55)), 80, lambda v: None)
    gui.createTrackbar("Param1", WINDOW, int(saved.get("param1", 100)), 200, lambda v: None)
    gui.createTrackbar("Param2", WINDOW, int(saved.get("param2", 25)), 60, lambda v: None)
    gui.createTrackbar("Center diff", WINDOW, int(saved.get("center_diff", 40)), 100,
                       lambda v: None)

    geometry = geo.BoardGeometry.from_config(config)
    pipe = state = out = current = pending = None
    pending_stable = frames = 0
    print("'s' saves settings, 'e' exports piece_stats.txt, 'q' quits")
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            settings = {
                "min_radius": max(gui.getTrackbarPos("Min radius %", WINDOW), 5),
                "max_radius": max(gui.getTrackbarPos("Max radius %", WINDOW), 10),
                "param1": max(gui.getTrackbarPos("Param1", WINDOW), 20),
                "param2": max(gui.getTrackbarPos("Param2", WINDOW), 5),
                "center_diff": max(gui.getTrackbarPos("Center diff", WINDOW), 5),
            }
            if settings != pending:
                pending = dict(settings)
                pending_stable = 0
            else:
                pending_stable += 1
            if settings != current and (pipe is None or pending_stable >= REBUILD_STILL_FRAMES):
                current = dict(settings)
                pipe = VisionPipeline(
                    geometry,
                    piece_settings=settings,  # the loader honors only min/max radius (quirk)
                    detector_overrides={
                        "hough_param1": settings["param1"],
                        "hough_param2": settings["param2"],
                        "center_diff_threshold": settings["center_diff"],
                    },
                    device=device,
                )
                state = pipe.capture_reference(pipe.init_state(), frame)

            state, out = pipe.step(state, frame, use_delta=False)
            out = outputs_to_numpy(out)
            vis = pipe.warp_board(frame)
            bs = pipe.geometry.board_size
            sq = bs // 8
            occ = out.raw_occupancy
            for s in range(64):
                if occ[s]:
                    f, r = s % 8, s // 8
                    col, row = f, 7 - r
                    cx, cy = col * sq + sq // 2, row * sq + sq // 2
                    color = METHOD_COLORS.get(int(out.method[s]), (200, 200, 200))
                    gui.circle(vis, (cx, cy), int(out.radius[s]), color, 2)
                    gui.putText(vis, f"{out.confidence[s]:.2f}",
                                (cx - 18, cy - int(out.radius[s]) - 4),
                                gui.FONT_HERSHEY_SIMPLEX, 0.45, color, 1)
            gui.putText(vis, f"minR={settings['min_radius']}% maxR={settings['max_radius']}% "
                        f"p1={settings['param1']} p2={settings['param2']} "
                        f"cd={settings['center_diff']} occupied={int(occ.sum())}",
                        (10, bs - 12), gui.FONT_HERSHEY_SIMPLEX, 0.55, (0, 255, 0), 2)
            gui.imshow(WINDOW, vis)
            frames += 1
            key = gui.waitKey(1) & 0xFF
            if key == ord("q"):
                break
            if key == ord("s"):
                save_json_config(PIECE_SETTINGS_FILE, current)
                print(f"saved {PIECE_SETTINGS_FILE}: {current}")
            elif key == ord("e") and out is not None:
                export_stats("piece_stats.txt", out, current)
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
    config = load_json_config(CALIBRATION_FILE)
    if config is None:
        print("run calibration first (tools.calibration_module)")
        return 1
    cap = cv2.VideoCapture(args.camera)
    if not cap.isOpened():
        print("failed to open camera")
        return 1
    run(cap, cv2, config, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
