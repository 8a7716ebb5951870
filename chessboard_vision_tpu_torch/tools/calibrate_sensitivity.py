"""Change-detector sensitivity calibrator (trackbar UI).

Counterpart of chessboard_vision_tpu.tools.calibrate_sensitivity
(reference calibrate_sensitivity.py): tune the z-threshold ("Sensitivity",
mapped 3.0 - v/20 as the reference's :116-118), the initial variance, alpha
and the change detector's blur kernel (:62-118) over a live
intensity-colored overlay, with the lifted-piece legal-destination preview
(:176-201) and a hand-test mode that counts noise events (:337-346). 's'
saves sensitivity_settings.json, which the pipeline reads
(``VisionPipeline(change_settings=...)``, blur kernel included), 'r'
re-captures the reference, 'h' toggles the hand test, 'q' quits.

``run`` takes any camera-like reader and a ``gui``: cv2's module, or any
object with the HighGUI and drawing attributes used here (``namedWindow``,
``createTrackbar``, ``getTrackbarPos``, ``imshow``, ``waitKey``,
``destroyAllWindows``, ``rectangle``, ``addWeighted``, ``putText``,
``circle``, ``FONT_HERSHEY_SIMPLEX``). ``main`` alone imports cv2.

Run: python -m chessboard_vision_tpu_torch.tools.calibrate_sensitivity [--device cuda]
"""

from __future__ import annotations

import argparse

from chessboard_vision_tpu_torch import geometry as geo
from chessboard_vision_tpu_torch.models.pipeline import (
    VisionPipeline,
    occupancy_to_set,
    outputs_to_numpy,
)
from chessboard_vision_tpu_torch.rules import GameState
from chessboard_vision_tpu_torch.tools.calibrate_piece_detector import REBUILD_STILL_FRAMES
from chessboard_vision_tpu_torch.utils.config import (
    CALIBRATION_FILE,
    SENSITIVITY_FILE,
    load_json_config,
    save_json_config,
)

WINDOW = "Sensitivity"
INTENSITY_COLORS = {1: (80, 190, 250), 2: (0, 140, 255), 3: (0, 0, 255)}  # LEVE/PARCIAL/TOTAL


def lifted_square_and_destinations(game: GameState, vision_occupied) -> tuple:
    """Lifted-piece preview (reference calibrate_sensitivity.py:176-201):
    when exactly one piece of the game position is visually missing (and
    nothing extra appeared), return it and its legal destination squares."""
    expected = game.get_board_occupancy()
    missing = expected - set(vision_occupied)
    extra = set(vision_occupied) - expected
    if len(missing) != 1 or extra:
        return None, []
    lifted = next(iter(missing))
    from_sq = lifted[1] * 8 + lifted[0]
    dests = [
        (m.to_square % 8, m.to_square // 8)
        for m in game.board.legal_moves
        if m.from_square == from_sq
    ]
    return lifted, dests


def run(cap, gui, config: dict, device="cuda") -> int:
    """The tuning loop over ``cap``'s frames until 'q' or the end of the
    capture; returns the frames shown. The pipeline is rebuilt on
    ``device`` once the sliders have been still for REBUILD_STILL_FRAMES
    frames, with a geometry whose square border covers the blur kernel
    (``blur_pad``) whenever the kernel changed. ``cap`` is released and the
    windows destroyed on the way out."""
    gui.namedWindow(WINDOW)
    saved = load_json_config(SENSITIVITY_FILE, {}) or {}
    gui.createTrackbar("Sensitivity", WINDOW, int((3.0 - saved.get("z_threshold", 2.5)) * 20),
                       50, lambda v: None)
    gui.createTrackbar("Init var", WINDOW, int(saved.get("initial_variance", 100)), 1000,
                       lambda v: None)
    gui.createTrackbar("Alpha x100", WINDOW, int(saved.get("alpha", 0.1) * 100), 50,
                       lambda v: None)
    gui.createTrackbar("Blur", WINDOW, int(saved.get("blur_kernel", 5)), 15, lambda v: None)

    pipe = state = current = pending = geometry = None
    pending_stable = frames = noise_events = 0
    game = GameState()
    hand_test = False
    print("'s' saves, 'r' recalibrates reference, 'h' toggles hand-test, 'q' quits")
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            z = 3.0 - gui.getTrackbarPos("Sensitivity", WINDOW) / 20.0
            var0 = max(gui.getTrackbarPos("Init var", WINDOW), 1)
            alpha = max(gui.getTrackbarPos("Alpha x100", WINDOW), 1) / 100.0
            blur = max(gui.getTrackbarPos("Blur", WINDOW), 1)
            blur += 1 - blur % 2  # odd kernel, like the reference's trackbar mapping
            settings = {"z_threshold": z, "initial_variance": var0, "alpha": alpha,
                        "blur_kernel": blur}
            if settings != pending:
                pending = dict(settings)
                pending_stable = 0
            else:
                pending_stable += 1
            if settings != current and (pipe is None or pending_stable >= REBUILD_STILL_FRAMES):
                if current is None or blur != current["blur_kernel"]:
                    geometry = geo.BoardGeometry.from_config(config, blur_pad=max(2, blur // 2))
                current = dict(settings)
                pipe = VisionPipeline(geometry, change_settings=settings, device=device)
                state = pipe.capture_reference(pipe.init_state(), frame)

            state, out = pipe.step(state, frame)
            out = outputs_to_numpy(out)
            vis = pipe.warp_board(frame)
            bs = pipe.geometry.board_size
            sq = bs // 8
            n_changed = 0
            for s in range(64):
                if out.change_intensity[s] > 0:
                    n_changed += 1
                    f, r = s % 8, s // 8
                    col, row = f, 7 - r
                    x1, y1 = col * sq, row * sq
                    overlay = vis.copy()
                    gui.rectangle(overlay, (x1, y1), (x1 + sq, y1 + sq),
                                  INTENSITY_COLORS[int(out.change_intensity[s])], -1)
                    gui.addWeighted(overlay, 0.4, vis, 0.6, 0, vis)
                    gui.putText(vis, f"{out.change_pct[s]:.0f}%", (x1 + 5, y1 + 20),
                                gui.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
            if hand_test and n_changed > 3:
                noise_events += 1

            lifted, dests = lifted_square_and_destinations(game, occupancy_to_set(out.occupancy))
            if lifted is not None:
                lf, lr = lifted
                x1, y1 = lf * sq, (7 - lr) * sq
                gui.rectangle(vis, (x1, y1), (x1 + sq, y1 + sq), (0, 255, 255), 2)
                for df, dr in dests:
                    cx, cy = df * sq + sq // 2, (7 - dr) * sq + sq // 2
                    gui.circle(vis, (cx, cy), sq // 5, (0, 255, 0), 2)

            gui.putText(vis, f"z={z:.2f} var={var0} a={alpha:.2f} blur={blur} changed={n_changed}"
                        + (f" noise_events={noise_events}" if hand_test else ""),
                        (10, bs - 12), gui.FONT_HERSHEY_SIMPLEX, 0.55, (0, 255, 0), 2)
            gui.imshow(WINDOW, vis)
            frames += 1
            key = gui.waitKey(1) & 0xFF
            if key == ord("q"):
                break
            if key == ord("s"):
                save_json_config(SENSITIVITY_FILE, current)
                print(f"saved {SENSITIVITY_FILE}: {current}")
            elif key == ord("r"):
                state = pipe.capture_reference(state, frame)
            elif key == ord("h"):
                hand_test = not hand_test
                noise_events = 0
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
