"""Piece-TYPE classification from per-square vision features -> full FEN.

The port's own copy of chessboard_vision_tpu.rules.piece_types (host
numpy, no device code): the same arrays, centroids and characters.

Beyond the reference's scope: its fen_generator.py:5-10 defines the
'white-pawn'..'black-king' label -> FEN char mapping and a labeled-
detection API that waits for a piece classifier which was never built
(SURVEY.md: fen_generator orphan). This module is that classifier.

Physical chess pieces differ by base diameter — the reference's own
calibrator exports measured radii of 23-35 px at 77 px squares
(reference piece_stats.txt:5-20) — and the fused device step
already measures every square TWO ways at zero extra cost:

- ``StepOutputs.radius``: the Hough detector's integer circle radius
  (only meaningful when the cascade's Hough stage resolved a circle —
  center_diff/symmetry squares carry a min_dim//3 FALLBACK, which this
  module masks out by method).
- ``StepOutputs.profile_extent``: the ring-coverage size profile
  (ops/piece.py) — each of the cascade's 4 concentric ring means is a
  linear piece/background intensity mix, so the summed clipped coverage
  fractions give a sub-pixel, monotone size readout in [0, 4] that
  works on EVERY occupied square regardless of which cascade method
  fired. This is the feature that splits close base diameters
  (knight/bishop) where the integer Hough radius ties, and that types
  squares the radius alone left as '?'.

A nearest-centroid model over (radius, extent), calibrated on ONE known
position (the initial setup — every game passes through it, and
GameSession.capture_reference happens exactly there), then reads piece
types straight off the board, upgrading colored FEN (light/dark) to a
full FEN placement. Distances are normalized per feature by the typical
adjacent-class gap so one noisy feature cannot swamp the other; a
square missing one feature matches on the other alone.

Classification never overrides the rules engine — it exists for
initial-board verification and desync recovery (board_verifiers'
sketched capability).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from chessboard_vision_tpu_torch.rules import chesslib as chess

# chesslib piece types are 1..6 (PAWN..KING); PIECE_SYMBOLS maps to chars.
TYPE_CHARS = "pnbrqk"

# Per-feature distance normalizers: the typical ADJACENT-CLASS gap, so a
# one-class error contributes ~1.0 in either feature. Radii of a Staunton
# spread step ~3-4 px at 77 px squares (reference piece_stats.txt); the
# ring-coverage extent steps ~0.4 per class for the same spread (each
# ring spans ~10 px of radius, so dr px of base radius moves the summed
# coverage by ~dr/10).
RADIUS_SCALE = 4.0
EXTENT_SCALE = 0.4

# Hough-family method codes (ops/piece.py): only these carry a measured
# circle radius; center_diff/symmetry report a min_dim//3 fallback that
# must NOT be fed to the radius centroids.
_RADIUS_METHODS = (1, 2)  # METHOD_HOUGH, METHOD_TOWER_TOP


def mask_radii_by_method(radius, method) -> np.ndarray:
    """Zero out radii of squares the cascade resolved WITHOUT a circle.

    StepOutputs.radius is min_dim//3 for center_diff/symmetry squares
    (the reference's fallback semantics, piece_detector.py:321-344) — a
    fake size reading. Sessions mask before windowing so average_radii's
    positive filter skips those squares and the extent feature types
    them instead.
    """
    rad = np.asarray(radius)
    meth = np.asarray(method)
    return np.where(np.isin(meth, _RADIUS_METHODS), rad, 0)


def average_radii(radii) -> np.ndarray:
    """Per-square mean of positive radius observations.

    radii: (F, 64) stacked StepOutputs.radius over F frames (or (64,)).
    The circle detector's per-frame radius estimate jitters by a few px
    under sensor noise (adjacent Hough radius bins trade votes); piece
    base diameters are ~3-4 px apart, so both calibration and readout
    should average a handful of frames — the session's stability gate
    (20 stable frames before any commit) provides exactly that window
    for free. Squares with no positive observation return 0.
    """
    arr = np.atleast_2d(np.asarray(radii, np.float64))
    pos = arr > 0
    n = pos.sum(axis=0)
    s = np.where(pos, arr, 0.0).sum(axis=0)
    return np.where(n > 0, s / np.maximum(n, 1), 0.0).reshape(-1)


# The extent window averages the same way (invalid observations are -1,
# valid ones comfortably positive — the smallest legal piece covers the
# innermost ring).
average_extents = average_radii


class PieceTypeClassifier:
    """Nearest-centroid piece-type model over (radius, extent) features.

    Features are per-(color, type): pieces of the same type share a base
    diameter; white and black sets are calibrated separately (some sets
    differ slightly, and it is free — the initial position shows all 12
    classes). ``centroids`` holds the radius feature (px) — kept as the
    plain float dict older callers/tests pin directly;
    ``extent_centroids`` holds the ring-coverage feature.
    """

    def __init__(self):
        # (color int, piece_type int) -> mean radius (px)
        self.centroids: Dict[Tuple[int, int], float] = {}
        # (color int, piece_type int) -> mean ring-coverage extent [0, 4]
        self.extent_centroids: Dict[Tuple[int, int], float] = {}
        # Per-square readout bias (px): the circle detector reads the same
        # piece 2-3 px differently depending on the square's CONTEXT
        # (crowded neighbors bleed edge votes; background texture shifts
        # the peak). The bias is a property of the square/rig, not the
        # piece, so it is learned from labeled samples and subtracted
        # before centroid matching. The extent feature carries no such
        # bias term: its rings live inside the square crop, so neighbor
        # context cannot shift it the way edge votes shift the Hough peak.
        self.square_bias = np.zeros(64)

    @staticmethod
    def _labeled_means(values, board, valid) -> Dict[Tuple[int, int], float]:
        vals = np.asarray(values, np.float64).reshape(64)
        ok = np.asarray(valid, bool).reshape(64)
        samples: Dict[Tuple[int, int], list] = {}
        for sq in range(64):
            piece = board.piece_at(sq)
            if piece is None or not ok[sq]:
                continue
            key = (int(piece.color), piece.piece_type)
            samples.setdefault(key, []).append(float(vals[sq]))
        return {k: float(np.mean(v)) for k, v in samples.items()}

    def calibrate(self, radius, board: "chess.Board", extents=None) -> Dict:
        """Fit centroids from a frame of a KNOWN position.

        radius: StepOutputs.radius, (64,) px in chess-square order
        (sq = rank*8 + file); board: the rules Board matching the frame;
        extents: optional (64,) StepOutputs.profile_extent (averaged like
        the radii). Squares whose cascade did not resolve a circle
        (radius <= 0) contribute nothing to the radius centroids but
        still contribute their extent. Returns the radius-centroid dict
        (empty AND no extents -> classify() returns all-unknown).
        """
        rad = np.asarray(radius).reshape(64)
        self.centroids = self._labeled_means(rad, board, rad > 0)
        if extents is not None:
            ext = np.asarray(extents).reshape(64)
            self.extent_centroids = self._labeled_means(ext, board, ext > 0)
        return self.centroids

    def update(self, radius, board: "chess.Board", blend: float = 0.5,
               extents=None) -> Dict:
        """Blend new labeled samples into centroids + per-square biases.

        Between committed moves the position is always known, so every
        stable window provides labeled samples for free. Centroids are
        updated from bias-corrected readings; each occupied square's bias
        then tracks its residual (reading - class centroid). Classes not
        seen before are adopted outright; existing ones move by ``blend``
        toward the new mean.
        """
        rad = np.asarray(radius).reshape(64)
        corrected = np.where(rad > 0, rad - self.square_bias, 0.0)
        for k, v in self._labeled_means(corrected, board, corrected > 0).items():
            if k in self.centroids:
                self.centroids[k] = (1.0 - blend) * self.centroids[k] + blend * v
            else:
                self.centroids[k] = v
        for sq in range(64):
            piece = board.piece_at(sq)
            if piece is None or rad[sq] <= 0:
                continue
            key = (int(piece.color), piece.piece_type)
            if key in self.centroids:
                resid = float(rad[sq]) - self.centroids[key]
                self.square_bias[sq] = (
                    (1.0 - blend) * self.square_bias[sq] + blend * resid
                )
        if extents is not None:
            ext = np.asarray(extents).reshape(64)
            for k, v in self._labeled_means(ext, board, ext > 0).items():
                if k in self.extent_centroids:
                    self.extent_centroids[k] = (
                        (1.0 - blend) * self.extent_centroids[k] + blend * v
                    )
                else:
                    self.extent_centroids[k] = v
        return self.centroids

    def classify(self, radius, occupancy, piece_colors, extents=None) -> np.ndarray:
        """Per-square FEN chars from vision features + the color classifier.

        radius/occupancy: StepOutputs arrays (64,); piece_colors: (64,)
        int8 from rules.classify_piece_colors (1 light / 0 dark / -1
        empty); extents: optional (64,) averaged profile_extent. Returns
        a (64,) object array of FEN chars ('' for empty, '?' for occupied
        squares the model cannot type: no usable feature, unknown color,
        or no centroids for that color). A square missing the radius
        (cascade resolved it without a circle) is typed from its extent
        alone — and vice versa.
        """
        rad = np.asarray(radius, np.float64).reshape(64)
        occ = np.asarray(occupancy, bool).reshape(64)
        col = np.asarray(piece_colors).reshape(64)
        ext = (
            np.asarray(extents, np.float64).reshape(64)
            if extents is not None else None
        )
        out = np.full(64, "", dtype=object)
        for sq in range(64):
            if not occ[sq]:
                continue
            if col[sq] < 0:
                out[sq] = "?"
                continue
            color = int(col[sq])
            r_reading = (
                float(rad[sq]) - self.square_bias[sq] if rad[sq] > 0 else None
            )
            e_reading = (
                float(ext[sq]) if ext is not None and ext[sq] > 0 else None
            )
            r_cands = {
                t: c for (c0, t), c in self.centroids.items() if c0 == color
            }
            e_cands = {
                t: c for (c0, t), c in self.extent_centroids.items()
                if c0 == color
            }
            best_t, best_d = None, np.inf
            for t in set(r_cands) | set(e_cands):
                d, n = 0.0, 0
                if r_reading is not None and t in r_cands:
                    d += ((r_cands[t] - r_reading) / RADIUS_SCALE) ** 2
                    n += 1
                if e_reading is not None and t in e_cands:
                    d += ((e_cands[t] - e_reading) / EXTENT_SCALE) ** 2
                    n += 1
                if n == 0:
                    continue
                d /= n  # a two-feature match must not lose to a
                # one-feature match merely by summing more terms
                if d < best_d:
                    best_t, best_d = t, d
            if best_t is None:
                out[sq] = "?"
                continue
            ch = chess.PIECE_SYMBOLS[best_t]
            out[sq] = ch.upper() if color == 1 else ch
        return out


def occupancy_to_full_fen(
    occupancy,
    type_chars,
    current_turn: str = "w",
    unknown_light: str = "P",
    unknown_dark: str = "p",
    piece_colors=None,
) -> str:
    """FEN placement from occupancy + per-square type chars.

    type_chars: (64,) chars from PieceTypeClassifier.classify. '?' squares
    degrade to the colored-FEN placeholder (pawn char by color) so the
    output is always a valid placement string.
    """
    from chessboard_vision_tpu_torch.rules.fen import generate_fen

    occ = np.asarray(occupancy, dtype=bool).reshape(8, 8)
    chars = np.asarray(type_chars).reshape(64)
    colors = (
        np.asarray(piece_colors).reshape(64) if piece_colors is not None else None
    )
    board_map = {}
    for f in range(8):
        for r in range(8):
            if not occ[f, r]:
                continue
            ch = chars[r * 8 + f]
            if ch in ("", "?"):
                dark = colors is not None and colors[r * 8 + f] == 0
                ch = unknown_dark if dark else unknown_light
            board_map[(f, 7 - r)] = {"fen": str(ch), "conf": 1.0, "class": "type"}
    return generate_fen(board_map, current_turn)
