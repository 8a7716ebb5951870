"""Stateful change-detector model (host-facing wrapper over ops/change).

Counterpart of chessboard_vision_tpu.models.change_detector, with the
reference ChangeDetector surface (change_detector.py): calibrate /
update_all_references / detect_changes(_detailed) / classify_hand_pattern /
focus squares. The per-square state is held as tensors on ``device`` (the
card unless the caller asks for the CPU); each call is a few tensor ops.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from chessboard_vision_tpu_torch.device import resolve_device
from chessboard_vision_tpu_torch.ops import change as change_ops
from chessboard_vision_tpu_torch.ops.layout import positions_to_mask

SquareTuple = Tuple[int, int]


class ChangeDetectorModel:
    def __init__(self, valid_mask=None, counts=None, shape=(64, 77, 77), device="cuda"):
        self.device = resolve_device(device, "ChangeDetectorModel")
        self.z_threshold = 2.5
        self.initial_variance = 100.0
        self.alpha = 0.1
        self.blur_kernel = 5
        self.shape = shape
        self.valid_mask = (
            self._tensor(valid_mask) if valid_mask is not None
            else torch.ones(shape, dtype=torch.bool, device=self.device)
        )
        self.counts = (
            self._tensor(counts) if counts is not None
            else torch.full((shape[0],), shape[1] * shape[2], dtype=torch.int32,
                            device=self.device)
        )
        self.state = change_ops.init_state(shape, device=self.device)
        self.is_calibrated = False
        self.focus_squares: set = set()

    def _tensor(self, x) -> torch.Tensor:
        """A host array or a tensor, on the model's device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    # -- configuration ---------------------------------------------------

    def set_focus_squares(self, squares):
        self.focus_squares = set(squares)

    def clear_focus(self):
        self.focus_squares = set()

    def get_focus_count(self):
        return len(self.focus_squares) if self.focus_squares else 64

    def _focus_mask(self) -> np.ndarray:
        if self.focus_squares:
            return positions_to_mask(self.focus_squares)
        return np.ones(64, bool)

    # -- model API (gray: (64, H, W) u8 preprocessed squares) -----------

    def calibrate(self, gray):
        self.state = change_ops.calibrate(self._tensor(gray), self.initial_variance)
        self.is_calibrated = True

    def update_all_references(self, gray):
        if not self.is_calibrated:
            self.calibrate(gray)
            return
        self.state = change_ops.update_references(
            self.state, self._tensor(gray), self.alpha, self._tensor(self._focus_mask())
        )

    def detect_changes_detailed(self, gray) -> Dict[SquareTuple, dict]:
        """Dict API matching the reference (only significant squares)."""
        if not self.is_calibrated:
            return {}
        det = change_ops.detect(
            self.state, self._tensor(gray), self.z_threshold, self.valid_mask, self.counts
        )
        z_peak, pct, intensity, sig = (
            x.cpu().numpy() for x in (det.z_peak, det.pct_changed, det.intensity, det.significant)
        )
        focus = self._focus_mask()
        out = {}
        for f in range(8):
            for r in range(8):
                sq = r * 8 + f
                if focus[sq] and sig[sq]:
                    out[(f, r)] = {
                        "z_score": float(z_peak[sq]),
                        "pct_changed": float(pct[sq]),
                        "intensity": change_ops.INTENSITY_NAMES[int(intensity[sq])],
                    }
        return out

    def detect_changes(self, gray) -> Dict[SquareTuple, float]:
        return {
            pos: info["pct_changed"]
            for pos, info in self.detect_changes_detailed(gray).items()
            if info["intensity"] in ("PARCIAL", "TOTAL")
        }

    def classify_hand_pattern(self, detailed: Dict[SquareTuple, dict]) -> dict:
        n = len(detailed)
        n_total = sum(1 for v in detailed.values() if v["intensity"] == "TOTAL")
        if n_total >= 2 or n >= 4 or n > 2:
            return {"is_hand": True, "is_move": False, "move_candidates": set()}
        cands = set(detailed.keys())
        return {"is_hand": False, "is_move": n == 2, "move_candidates": cands}
