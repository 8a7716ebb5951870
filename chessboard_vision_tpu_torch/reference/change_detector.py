"""OpenCV oracle for the per-square change detector.

Counterpart of chessboard_vision_tpu.reference.change_detector (reference
change_detector.py, ChangeDetectorPython and its Cython twin): per-pixel
running-Gaussian background model (mean/var EMA), z-score maps,
percent-changed intensity classes, and the hand-vs-move heuristic. cv2 is
imported in ``__init__``.
"""

from __future__ import annotations

import numpy as np

from chessboard_vision_tpu_torch.reference.piece_detector import PieceDetectorCV


class ChangeDetectorCV:
    def __init__(self):
        import cv2

        self._cv2 = cv2
        self.z_threshold = 2.5
        self.initial_variance = 100
        self.alpha = 0.1
        self.blur_kernel = 5

        self.means: dict = {}
        self.variances: dict = {}
        self.is_calibrated = False
        self.focus_squares: set = set()
        self.piece_detector = PieceDetectorCV()

    def _preprocess(self, img):
        gray = self._cv2.cvtColor(img, self._cv2.COLOR_BGR2GRAY) if img.ndim == 3 else img
        k = self.blur_kernel | 1
        return self._cv2.GaussianBlur(gray, (k, k), 0)

    def calibrate(self, squares):
        self.means = {}
        self.variances = {}
        for pos, img in squares.items():
            gray = self._preprocess(img)
            self.means[pos] = gray.astype(np.float32)
            self.variances[pos] = np.full(gray.shape, self.initial_variance, np.float32)
        self.is_calibrated = True

    def set_focus_squares(self, squares):
        self.focus_squares = set(squares)

    def clear_focus(self):
        self.focus_squares = set()

    def get_focus_count(self):
        return len(self.focus_squares) if self.focus_squares else 64

    def update_all_references(self, squares):
        if not self.is_calibrated:
            self.calibrate(squares)
            return
        for pos, img in squares.items():
            if self.focus_squares and pos not in self.focus_squares:
                continue
            gray = self._preprocess(img).astype(np.float32)
            mean = self.means[pos]
            var = self.variances[pos]
            new_mean = (1 - self.alpha) * mean + self.alpha * gray
            diff = gray - new_mean
            new_var = (1 - self.alpha) * var + self.alpha * (diff**2)
            self.means[pos] = new_mean
            self.variances[pos] = np.maximum(new_var, 10.0)

    def detect_changes(self, squares):
        detailed = self.detect_changes_detailed(squares)
        return {
            pos: info["pct_changed"]
            for pos, info in detailed.items()
            if info["intensity"] in ("PARCIAL", "TOTAL")
        }

    def detect_changes_detailed(self, squares):
        results = {}
        if not self.is_calibrated:
            return results
        to_check = self.focus_squares if self.focus_squares else squares.keys()
        for pos in to_check:
            if pos not in squares:
                continue
            img = squares[pos]
            gray = self._preprocess(img).astype(np.float32)
            mean = self.means.get(pos)
            var = self.variances.get(pos)
            if mean is None:
                continue
            z = np.abs(gray - mean) / np.sqrt(var)
            changed = np.count_nonzero(z > self.z_threshold)
            pct = changed / gray.size * 100
            if pct < 5.0:
                continue
            if pct > 75:
                intensity = "TOTAL"
            elif pct > 15:
                intensity = "PARCIAL"
            else:
                intensity = "LEVE"
            results[pos] = {
                "z_score": float(np.max(z)),
                "pct_changed": pct,
                "intensity": intensity,
                "is_circular": self.piece_detector.detect_piece(img, pos)["has_piece"],
                "center_ratio": 1.0,
            }
        return results

    def classify_hand_pattern(self, detailed):
        n = len(detailed)
        n_total = sum(1 for v in detailed.values() if v["intensity"] == "TOTAL")
        if n_total >= 2 or n >= 4 or n > 2:
            return {"is_hand": True, "is_move": False, "move_candidates": set()}
        candidates = set(detailed.keys())
        return {"is_hand": False, "is_move": len(candidates) == 2, "move_candidates": candidates}
