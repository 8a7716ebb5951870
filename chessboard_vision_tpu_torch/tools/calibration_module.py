"""Interactive board calibration (4-corner click UI + smart grid).

Counterpart of chessboard_vision_tpu.tools.calibration_module (reference
calibration_module.py): click the four corners, verify the warp live,
choose the orientation ('w'/'b'), optionally refine the grid ('g': the
Canny projection profiles of geometry.refine_grid, on ``device``), save
with 's'. Writes the same calibration.json schema (corners, player_color,
orientation_flipped, grid_lines_x/y).

The UI goes through ``gui``: cv2's module, or any object with the HighGUI
and drawing attributes used here (``namedWindow``, ``setMouseCallback``,
``imshow``, ``waitKey``, ``destroyAllWindows``, ``circle``, ``putText``,
``polylines``, ``line``, ``warpPerspective``, ``rotate`` and cv2's
constants ``EVENT_LBUTTONDOWN``, ``FONT_HERSHEY_SIMPLEX``, ``ROTATE_180``).
With none given, ``run`` imports cv2.

Run: python -m chessboard_vision_tpu_torch.tools.calibration_module [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

from chessboard_vision_tpu_torch import geometry as geo
from chessboard_vision_tpu_torch.utils.config import (
    CALIBRATION_FILE,
    load_json_config,
    save_json_config,
)


class CalibrationModule:
    def __init__(self, gui=None, device="cuda"):
        self.points = []
        self.gui = gui
        self.device = device

    def run(self, cap, allow_load: bool = True):
        """Interactive calibration from the camera-like reader ``cap``;
        returns the config dict, or None when cancelled. With a saved
        calibration and ``allow_load``, asks on stdin whether to load it."""
        if self.gui is None:
            import cv2

            self.gui = cv2
        gui = self.gui
        if allow_load:
            saved = load_json_config(CALIBRATION_FILE)
            if saved is not None:
                ans = input(f"Load saved calibration from {CALIBRATION_FILE}? (y/n): ")
                if ans.strip().lower() == "y":
                    print("[calib] configuration loaded")
                    return saved

        print("Click the 4 board corners (TL, TR, BL, BR). 'r' resets, 'q' quits.")
        gui.namedWindow("Calibration")
        gui.setMouseCallback("Calibration", self._mouse_callback)
        while True:
            ok, img = cap.read()
            if not ok:
                print("[calib] camera failure")
                return None
            display = img.copy()
            for i, pt in enumerate(self.points):
                gui.circle(display, tuple(pt), 5, (0, 0, 255), -1)
                gui.putText(display, str(i + 1), (pt[0] + 10, pt[1]),
                            gui.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
            if len(self.points) == 4:
                pts = np.array(self.points, np.int32).reshape((-1, 1, 2))
                gui.polylines(display, [pts], True, (0, 255, 0), 2)
                gui.putText(display, "Press ENTER to confirm", (50, 50),
                            gui.FONT_HERSHEY_SIMPLEX, 0.7, (0, 255, 0), 2)
            gui.imshow("Calibration", display)
            key = gui.waitKey(1) & 0xFF
            if key == ord("q"):
                gui.destroyAllWindows()
                return None
            if key == ord("r"):
                self.points = []
            elif key == 13 and len(self.points) == 4:
                break
        return self._configure_details(cap, np.array(self.points))

    def _mouse_callback(self, event, x, y, flags, param):
        if event == self.gui.EVENT_LBUTTONDOWN and len(self.points) < 4:
            self.points.append([x, y])

    def _configure_details(self, cap, corners):
        """The verification loop over the warped board: orientation, smart
        grid, save; returns the saved config, or None."""
        gui = self.gui
        ordered = geo.reorder(corners.reshape((4, 1, 2)))
        flipped = False
        grid_x = grid_y = None
        print("\n-- verification: 'w'=white, 'b'=black (flip), 'g'=smart grid, "
              "'s'=save, 'q'=cancel --")
        M, bs = geo.warp_matrix(ordered)
        while True:
            ok, img = cap.read()
            if not ok:
                break
            warped = gui.warpPerspective(img, M, (bs, bs))
            if flipped:
                warped = gui.rotate(warped, gui.ROTATE_180)
            display = warped.copy()
            gx = grid_x or geo.linear_grid_lines(bs)
            gy = grid_y or geo.linear_grid_lines(bs)
            for x in gx:
                gui.line(display, (int(x), 0), (int(x), bs), (0, 255, 0), 1)
            for y in gy:
                gui.line(display, (0, int(y)), (bs, int(y)), (0, 255, 0), 1)
            if grid_x:
                gui.putText(display, "SMART GRID", (10, 30),
                            gui.FONT_HERSHEY_SIMPLEX, 0.7, (0, 255, 0), 2)
            gui.imshow("Verification", display)
            key = gui.waitKey(1) & 0xFF
            if key == ord("q"):
                gui.destroyAllWindows()
                return None
            if key == ord("w"):
                if flipped:
                    # Refined lines belong to the other orientation: a
                    # 180-degree flip mirrors every asymmetric line.
                    grid_x, grid_y = None, None
                flipped = False
            elif key == ord("b"):
                if not flipped:
                    grid_x, grid_y = None, None
                flipped = True
            elif key == ord("g"):
                grid_x, grid_y = geo.refine_grid(warped, device=self.device)
                print(f"[calib] smart grid: x={grid_x} y={grid_y}")
            elif key == ord("s"):
                config = {
                    "corners": corners.tolist(),
                    "player_color": "black" if flipped else "white",
                    "orientation_flipped": flipped,
                    "grid_lines_x": [int(v) for v in grid_x] if grid_x else None,
                    "grid_lines_y": [int(v) for v in grid_y] if grid_y else None,
                }
                save_json_config(CALIBRATION_FILE, config)
                gui.destroyAllWindows()
                return config


def main(argv=None):
    """Open the camera at 1280x720 and run the click UI in cv2's HighGUI
    (reference play_lichess.py:16-18 camera settings)."""
    import cv2

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--camera", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    args = ap.parse_args(argv)
    cap = cv2.VideoCapture(args.camera)
    cap.set(cv2.CAP_PROP_FRAME_WIDTH, 1280)
    cap.set(cv2.CAP_PROP_FRAME_HEIGHT, 720)
    try:
        config = CalibrationModule(gui=cv2, device=args.device).run(cap)
        print("[calib] done" if config else "[calib] cancelled")
    finally:
        cap.release()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
