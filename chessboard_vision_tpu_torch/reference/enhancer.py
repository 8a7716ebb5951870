"""OpenCV oracle for the image-enhancement pipeline.

Counterpart of chessboard_vision_tpu.reference.enhancer (reference
frame_enhancer.py, ImageEnhancerPython): 5-stage pipeline (0) HSV
color-profile remap, (1) CLAHE clip=3.0 8x8 on LAB-L, (2) bilateral d=9
sigma 75/75, (3) 3x3 sharpen, (4) min-max normalize; plus prepare_analysis:
gray -> Gaussian 5x5 -> Otsu binary. cv2 is imported in ``__init__`` and in
``apply_color_profile_cv``.
"""

from __future__ import annotations

import numpy as np

SHARPEN_KERNEL = np.array([[-1, -1, -1], [-1, 9, -1], [-1, -1, -1]])

DEFAULT_PROFILE = {
    "hue_shift": 0,
    "sat_scale": 1.0,
    "val_scale": 1.0,
    "contrast": 1.0,
    "brightness": 0,
    "radical_mode": 0,
    "target_hue": 0,
    "hue_window": 20,
}


def apply_color_profile_cv(frame: np.ndarray, profile: dict) -> np.ndarray:
    """HSV remap stage (reference frame_enhancer.py:56-99)."""
    if not profile:
        return frame
    import cv2

    p = {**DEFAULT_PROFILE, **profile}
    frame = cv2.convertScaleAbs(frame, alpha=p["contrast"], beta=p["brightness"])
    hsv = cv2.cvtColor(frame, cv2.COLOR_BGR2HSV).astype(np.float32)
    h, s, v = cv2.split(hsv)
    if p["radical_mode"]:
        h_dist = np.abs(h - p["target_hue"])
        h_dist = np.minimum(h_dist, 180 - h_dist)
        mask = h_dist < p["hue_window"]
        s[mask] = s[mask] * 2.0
        s[~mask] = s[~mask] * 0.5
    h = (h + p["hue_shift"]) % 180
    s = s * p["sat_scale"]
    v = v * p["val_scale"]
    h = np.clip(h, 0, 179)
    s = np.clip(s, 0, 255)
    v = np.clip(v, 0, 255)
    hsv_final = cv2.merge([h, s, v]).astype(np.uint8)
    return cv2.cvtColor(hsv_final, cv2.COLOR_HSV2BGR)


class ImageEnhancerCV:
    """Drop-in oracle with the reference ImageEnhancer API."""

    def __init__(self, clahe_clip_limit=3.0, tile_grid_size=(8, 8), profile=None):
        import cv2

        self._cv2 = cv2
        self.clahe = cv2.createCLAHE(clipLimit=clahe_clip_limit, tileGridSize=tile_grid_size)
        self.profile = dict(profile) if profile else {}

    def apply_color_profile(self, frame):
        return apply_color_profile_cv(frame, self.profile)

    def correct_lighting(self, frame):
        cv2 = self._cv2
        lab = cv2.cvtColor(frame, cv2.COLOR_BGR2LAB)
        l, a, b = cv2.split(lab)
        return cv2.cvtColor(cv2.merge((self.clahe.apply(l), a, b)), cv2.COLOR_LAB2BGR)

    def reduce_noise(self, frame):
        return self._cv2.bilateralFilter(frame, d=9, sigmaColor=75, sigmaSpace=75)

    def sharpen(self, frame):
        return self._cv2.filter2D(frame, -1, SHARPEN_KERNEL)

    def normalize_intensity(self, frame):
        cv2 = self._cv2
        return cv2.normalize(frame, None, alpha=0, beta=255, norm_type=cv2.NORM_MINMAX)

    def prepare_analysis(self, frame):
        cv2 = self._cv2
        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        gray_blurred = cv2.GaussianBlur(gray, (5, 5), 0)
        _, binary = cv2.threshold(gray_blurred, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        return gray, binary

    def process_pipeline(self, frame):
        frame = self.apply_color_profile(frame)
        out = self.correct_lighting(frame)
        out = self.reduce_noise(out)
        out = self.sharpen(out)
        return self.normalize_intensity(out)
