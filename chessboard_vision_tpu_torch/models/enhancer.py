"""Image enhancer: the reference's 5-stage enhancement pipeline on a device.

Counterpart of chessboard_vision_tpu.models.enhancer (reference
frame_enhancer.py ImageEnhancer): (0) HSV color-profile remap, (1) CLAHE
clip 3.0, 8x8 tiles on LAB-L, (2) bilateral d=9, sigma 75/75, (3) 3x3
sharpen, (4) min-max normalize; plus ``prepare_analysis`` (gray -> 5x5
Gaussian -> Otsu). The functions take planar (3, H, W) u8 tensors; the
CLAHE phases and the bilateral run the port's CUDA kernels when the tensor
is on a card and their plain versions when it is on the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from chessboard_vision_tpu_torch.device import resolve_device
from chessboard_vision_tpu_torch.ops import color as color_ops
from chessboard_vision_tpu_torch.ops import enhance as enh_ops
from chessboard_vision_tpu_torch.ops.filters import gaussian_blur, normalize_minmax, sharpen
from chessboard_vision_tpu_torch.ops.layout import to_planar
from chessboard_vision_tpu_torch.ops.threshold import otsu_binarize
from chessboard_vision_tpu_torch.utils.config import COLOR_PROFILE_FILE, load_json_config

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


def _hwc(planar: torch.Tensor) -> torch.Tensor:
    return planar.movedim(-3, -1)


def _planar(hwc: torch.Tensor) -> torch.Tensor:
    return hwc.movedim(-1, -3)


def apply_color_profile(planar: torch.Tensor, profile: dict) -> torch.Tensor:
    """HSV remap stage (reference frame_enhancer.py:56-99) on (3, H, W) u8."""
    if not profile:
        return planar
    p = {**DEFAULT_PROFILE, **profile}
    x = color_ops.convert_scale_abs(planar, p["contrast"], p["brightness"])
    h, s, v = color_ops.bgr2hsv(_hwc(x)).float().unbind(-1)
    if p["radical_mode"]:
        h_dist = (h - p["target_hue"]).abs()
        h_dist = torch.minimum(h_dist, 180.0 - h_dist)
        s = torch.where(h_dist < p["hue_window"], s * 2.0, s * 0.5)
    h = torch.remainder(h + p["hue_shift"], 180.0)
    s = s * p["sat_scale"]
    v = v * p["val_scale"]
    hsv_u8 = torch.stack([h.clamp(0, 179), s.clamp(0, 255), v.clamp(0, 255)], -1)
    return _planar(color_ops.hsv2bgr(hsv_u8.to(torch.uint8)))


def bilateral(planar: torch.Tensor) -> torch.Tensor:
    """Bilateral d=9, sigma 75/75: the CUDA kernel for a tensor on a card,
    its plain version for a tensor on the CPU (the JAX package's
    Pallas-else-XLA backend seam has no counterpart)."""
    return enh_ops.bilateral_planar(planar, 9, 75.0, 75.0)


def correct_lighting(planar: torch.Tensor, clahe_clip: float = 3.0,
                     clahe_tiles: int = 8) -> torch.Tensor:
    """CLAHE on the L channel of a Lab round trip, (3, H, W) u8."""
    lab = color_ops.planar_bgr2lab(planar)
    l_enh = enh_ops.clahe(lab[0], clahe_clip, clahe_tiles)
    return color_ops.planar_lab2bgr(torch.cat([l_enh[None], lab[1:]], 0))


def enhance_planar(planar: torch.Tensor, profile: Optional[dict] = None,
                   clahe_clip: float = 3.0, clahe_tiles: int = 8) -> torch.Tensor:
    """The full 5-stage enhancement on a (3, H, W) u8 planar image
    (reference process_pipeline, frame_enhancer.py:161-181): color profile
    -> CLAHE on LAB-L -> bilateral -> sharpen -> min-max normalize."""
    x = apply_color_profile(planar, profile or {})
    x = correct_lighting(x, clahe_clip, clahe_tiles)
    return normalize_minmax(sharpen(bilateral(x)))


class ImageEnhancer:
    """The reference ImageEnhancer API (HWC BGR numpy in and out), each stage
    run on ``device``."""

    def __init__(self, clahe_clip_limit: float = 3.0, tile_grid_size=(8, 8),
                 profile: Optional[dict] = None, load_profile_file: bool = False,
                 device="cuda"):
        self.clip = float(clahe_clip_limit)
        self.tiles = int(tile_grid_size[0])
        if profile is None and load_profile_file:
            profile = load_json_config(COLOR_PROFILE_FILE, {})
        self.profile = dict(profile) if profile else {}
        self.device = resolve_device(device, "ImageEnhancer")

    def _run(self, fn, frame) -> np.ndarray:
        """fn on the frame's planar tensor on the device; the result as a
        C-contiguous HWC array on the host, as cv2 returns it (cv2 draws
        only on such arrays)."""
        planar = torch.as_tensor(to_planar(frame), device=self.device)
        return _hwc(fn(planar)).contiguous().cpu().numpy()

    def apply_color_profile(self, frame) -> np.ndarray:
        return self._run(lambda x: apply_color_profile(x, self.profile), frame)

    def correct_lighting(self, frame) -> np.ndarray:
        return self._run(lambda x: correct_lighting(x, self.clip, self.tiles), frame)

    def reduce_noise(self, frame) -> np.ndarray:
        return self._run(bilateral, frame)

    def sharpen(self, frame) -> np.ndarray:
        return self._run(sharpen, frame)

    def normalize_intensity(self, frame) -> np.ndarray:
        return self._run(normalize_minmax, frame)

    def process_pipeline(self, frame) -> np.ndarray:
        return self._run(lambda x: enhance_planar(x, self.profile, self.clip, self.tiles), frame)

    def prepare_analysis(self, frame):
        """(gray, Otsu binary of the 5x5-blurred gray), (H, W) u8 each."""
        hwc = torch.as_tensor(np.asarray(frame), device=self.device)
        gray = color_ops.bgr2gray(hwc)
        _, binary = otsu_binarize(gaussian_blur(gray, 5))
        return gray.cpu().numpy(), binary.cpu().numpy()
