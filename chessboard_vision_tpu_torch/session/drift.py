"""Calibration-drift detection: a bumped camera heals itself.

Counterpart of chessboard_vision_tpu.session.drift. A periodic check
re-runs the automatic corner detector (geometry.find_chessboard_corners:
its image stages on the monitor's device, its contour stages on the host)
on the live frame and watches the detected corners MOVE. A confirmed,
consistent shift triggers the session's re-calibration: new geometry and
plans, fresh visual references, the game kept.

The detector has a constant outset bias (~6 px at 720p: the dilated
contour wraps the board's outer edge), so a detection is not compared with
the clicked corners. The FIRST successful detection is the baseline; drift
is measured against it, and on confirmation the RELATIVE shift is applied
to the calibrated corners, where the bias cancels.

Three gates before a shift is reported:
1. the detector must find a board (busy scenes return nothing);
2. the mean corner displacement must exceed ``threshold_px`` and stay
   within ``max_px`` (a huge "shift" is the contour locking onto another
   rectangle, not a bump);
3. ``confirm`` consecutive checks must agree with each other within
   ``threshold_px`` (a hand crossing the board gives unstable corners, a
   real bump the same new corners every check).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from chessboard_vision_tpu_torch import geometry as geo
from chessboard_vision_tpu_torch.utils.logging import get_logger


class DriftMonitor:
    """Tracks detected-corner displacement relative to a baseline detection."""

    def __init__(
        self,
        corners: np.ndarray,
        threshold_px: float = 4.0,
        max_px: float = 80.0,
        confirm: int = 2,
        device="cuda",
    ):
        self.corners = np.asarray(corners, np.float64).reshape(4, 2)
        self.threshold_px = float(threshold_px)
        self.max_px = float(max_px)
        self.confirm = int(confirm)
        self.device = device
        self._baseline: Optional[np.ndarray] = None
        self._pending: Optional[np.ndarray] = None
        self._agree = 0
        self.log = get_logger("drift")

    @staticmethod
    def _mean_disp(a: np.ndarray, b: np.ndarray) -> float:
        return float(np.mean(np.linalg.norm(a - b, axis=-1)))

    def check(self, frame: np.ndarray) -> Optional[np.ndarray]:
        """One drift check on a raw (H, W, 3) BGR camera frame. Returns the
        new (4, 2) calibration corners when drift is confirmed, else None.
        On confirmation the monitor re-bases, so one bump reports once."""
        detected = geo.find_chessboard_corners(frame, device=self.device)
        if detected.size != 8:
            self._pending, self._agree = None, 0  # gate 1: no board found
            return None
        det = np.asarray(detected, np.float64).reshape(4, 2)

        if self._baseline is None:
            self._baseline = det  # the detector's own (biased) view at calibration
            return None

        disp = self._mean_disp(det, self._baseline)
        if disp <= self.threshold_px or disp > self.max_px:  # gate 2
            self._pending, self._agree = None, 0
            return None

        if self._pending is not None and self._mean_disp(det, self._pending) <= self.threshold_px:
            self._agree += 1  # gate 3: consecutive checks agree
        else:
            self._pending = det
            self._agree = 1
        if self._agree < self.confirm:
            self.log.info("possible calibration drift: %.1f px (check %d/%d)",
                          disp, self._agree, self.confirm)
            return None

        self.log.warning("calibration drift confirmed: corners moved %.1f px", disp)
        # The relative shift: the detector's constant bias cancels.
        self.corners = self.corners + (det - self._baseline)
        self._baseline = det
        self._pending, self._agree = None, 0
        return self.corners.copy()
