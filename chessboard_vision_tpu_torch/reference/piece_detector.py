"""OpenCV oracle for per-square piece/occupancy detection.

Counterpart of chessboard_vision_tpu.reference.piece_detector (reference
piece_detector.py): std-dev uniformity prefilter, unified HoughCircles
cascade, center-vs-corner intensity diff, radial ring-variance symmetry,
plus delta caching and 5-frame temporal smoothing. cv2 is imported in
``__init__``.
"""

from __future__ import annotations

import numpy as np


class PieceDetectorCV:
    def __init__(self, settings: dict | None = None):
        import cv2

        self._cv2 = cv2
        self.min_radius_ratio = 0.20
        self.max_radius_ratio = 0.55
        self.edge_threshold = 50
        self.circle_threshold = 0.6
        self.hough_param1 = 100
        self.hough_param2 = 25

        self.history_size = 5
        self.min_presence = 0.6
        self.detection_history: dict = {}

        self.reference_squares: dict = {}
        self.cached_results: dict = {}
        self.change_threshold = 25

        if settings:
            # Reference quirk preserved: only min/max radius honored from
            # settings (piece_detector.py:58-65) — hough params are ignored.
            if "min_radius" in settings:
                self.min_radius_ratio = settings["min_radius"] / 100.0
            if "max_radius" in settings:
                self.max_radius_ratio = settings["max_radius"] / 100.0

    # -- preprocessing / delta cache ------------------------------------

    def _preprocess_square(self, square_img):
        if square_img.ndim == 3:
            gray = self._cv2.cvtColor(square_img, self._cv2.COLOR_BGR2GRAY)
        else:
            gray = square_img.copy()
        return self._cv2.GaussianBlur(gray, (5, 5), 0)

    def _has_changed(self, pos, current_gray):
        if pos not in self.reference_squares:
            return True
        diff = self._cv2.absdiff(current_gray, self.reference_squares[pos])
        return np.mean(diff) > self.change_threshold

    def _update_reference(self, pos, gray):
        self.reference_squares[pos] = gray.copy()

    # -- temporal smoothing ---------------------------------------------

    def _update_history(self, pos, has_piece):
        hist = self.detection_history.setdefault(pos, [])
        hist.append(has_piece)
        if len(hist) > self.history_size:
            hist.pop(0)

    def _get_stable_detection(self, pos):
        hist = self.detection_history.get(pos)
        if not hist:
            return False
        if len(hist) < 3:
            return hist[-1]
        return sum(hist) / len(hist) >= self.min_presence

    # -- detection methods ----------------------------------------------

    def _detect_circle_unified(self, gray):
        h, w = gray.shape
        min_dim = min(h, w)
        circles = self._cv2.HoughCircles(
            gray,
            self._cv2.HOUGH_GRADIENT,
            dp=1.2,
            minDist=min_dim // 3,
            param1=self.hough_param1,
            param2=self.hough_param2,
            minRadius=int(min_dim * self.min_radius_ratio),
            maxRadius=int(min_dim * self.max_radius_ratio),
        )
        if circles is None or len(circles[0]) == 0:
            return False, None, None, None
        cx0, cy0 = w // 2, h // 2
        max_offset = min_dim * 0.3
        best, best_d = None, float("inf")
        for circle in circles[0]:
            cx, cy, r = circle
            d = np.sqrt((cx - cx0) ** 2 + (cy - cy0) ** 2)
            if d < max_offset and d < best_d:
                best, best_d = circle, d
        if best is None:
            return False, None, None, None
        r = int(best[2])
        kind = "tower_top" if r < min_dim * 0.20 else "hough"
        return True, (int(best[0]), int(best[1])), r, kind

    def _detect_center_vs_border(self, gray):
        h, w = gray.shape
        cy, cx = h // 2, w // 2
        radius = min(h, w) // 4
        yy, xx = np.ogrid[:h, :w]
        center_mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= radius**2
        cs = min(h, w) // 4
        border_mask = np.zeros((h, w), bool)
        border_mask[:cs, :cs] = border_mask[:cs, -cs:] = True
        border_mask[-cs:, :cs] = border_mask[-cs:, -cs:] = True
        cm = np.mean(gray[center_mask])
        bm = np.mean(gray[border_mask])
        return abs(cm - bm), cm, bm

    def _analyze_radial_symmetry(self, gray):
        h, w = gray.shape
        cy, cx = h // 2, w // 2
        yy, xx = np.ogrid[:h, :w]
        dist = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        ring_means = []
        for ratio in (0.15, 0.25, 0.35, 0.45):
            r = min(h, w) * ratio
            ring = (dist >= r - 5) & (dist <= r + 5)
            if ring.sum() > 0:
                ring_means.append(np.mean(gray[ring]))
        if len(ring_means) < 2:
            return 0.0
        return min(1.0, np.var(ring_means) / 500)

    def detect_piece(self, square_img, pos=None):
        gray = self._preprocess_square(square_img)
        h, w = gray.shape
        result = {
            "has_piece": False,
            "confidence": 0.0,
            "center": None,
            "radius": None,
            "method": None,
            "center_border_diff": 0,
            "is_ellipse": False,
            "axes": None,
        }
        if np.std(gray) < 15:
            return result

        found, center, radius, kind = self._detect_circle_unified(gray)
        if found:
            result.update(
                has_piece=True,
                center=center,
                radius=radius,
                method=kind,
                confidence=0.9 if kind == "hough" else 0.75,
            )
            return result

        diff, _, _ = self._detect_center_vs_border(gray)
        result["center_border_diff"] = diff
        if diff > 40:
            result.update(
                has_piece=True,
                center=(w // 2, h // 2),
                radius=min(h, w) // 3,
                method="center_diff",
                confidence=min(1.0, diff / 80),
            )
            return result

        symmetry = self._analyze_radial_symmetry(gray)
        if symmetry > self.circle_threshold:
            result.update(
                has_piece=True,
                center=(w // 2, h // 2),
                radius=min(h, w) // 3,
                method="symmetry",
                confidence=symmetry,
            )
        return result

    # -- batch API (delta cache + smoothing) ----------------------------

    def calibrate_reference(self, squares_dict):
        self.reference_squares.clear()
        self.cached_results.clear()
        for pos, img in squares_dict.items():
            gray = self._preprocess_square(img)
            self.reference_squares[pos] = gray.copy()
            self.cached_results[pos] = self.detect_piece(img, pos)

    def detect_all_pieces(self, squares_dict, use_smoothing=True, use_delta=True, squares_to_check=None):
        results = {}
        visual_changes = set()
        for pos, img in squares_dict.items():
            gray = self._preprocess_square(img)
            has_changed_visual = self._has_changed(pos, gray)
            if has_changed_visual:
                visual_changes.add(pos)

            should_process = False
            if squares_to_check is not None and pos in squares_to_check:
                should_process = True
            if not should_process and (squares_to_check is None or use_delta):
                if pos not in self.cached_results or has_changed_visual:
                    should_process = True

            if should_process:
                raw = self.detect_piece(img, pos)
                self.cached_results[pos] = raw.copy()
            else:
                cached = self.cached_results.get(pos)
                if cached is None:
                    raw = self.detect_piece(img, pos)
                    self.cached_results[pos] = raw.copy()
                else:
                    raw = cached.copy()
            raw_has_piece = raw["has_piece"]

            self._update_history(pos, raw_has_piece)

            is_stable_update = True
            if use_smoothing:
                stable = self._get_stable_detection(pos)
                raw["has_piece"] = stable
                if raw_has_piece != stable:
                    is_stable_update = False

            if should_process and is_stable_update:
                self._update_reference(pos, gray)

            results[pos] = raw
        return results, visual_changes

    def get_occupied_squares(self, squares_dict, use_smoothing=True):
        results, _ = self.detect_all_pieces(squares_dict, use_smoothing)
        return {pos for pos, info in results.items() if info["has_piece"]}

    def update_references(self, squares_dict):
        for pos, img in squares_dict.items():
            self._update_reference(pos, self._preprocess_square(img))
        self.cached_results.clear()
