"""Top-level convenience API: the BASELINE-named entry points.

Counterpart of chessboard_vision_tpu.api. BASELINE.json names the public
surface a reference user expects: ``enhance_frame, extract_grid,
detect_pieces, detect_changes, FEN generation``. These are one-call host
wrappers (numpy HWC BGR u8 in, host values out) over the device pipeline;
production code uses ``models.pipeline.VisionPipeline`` /
``session.game_session.GameSession`` directly and threads its own state.

Every entry point runs on ``device``: the card unless the caller passes
``device="cpu"``; without a card, "cuda" raises. Pipelines are cached per
(corners, settings, device) with one initial state each, which every call
reads and none writes (a step returns a new state); enhancers are cached
per (profile, device).

As in the JAX api, the board geometry assumes the reference's 1280x720
capture (a 620 px board): the entry points that take ``corners`` read
1280x720 frames. Footage of another size goes through
tools/process_video.py or a GameSession, whose calibration config names
its ``display_size``.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Set, Tuple

import numpy as np

from chessboard_vision_tpu_torch import geometry as geo
from chessboard_vision_tpu_torch.device import resolve_device
from chessboard_vision_tpu_torch.rules.fen import (  # noqa: F401  (re-exports)
    generate_fen,
    map_detections_to_board,
    occupancy_to_colored_fen,
    occupancy_to_fen,
)

SquareTuple = Tuple[int, int]

_pipelines: dict = {}
_enhancers: dict = {}


def enhance_frame(frame: np.ndarray, profile: Optional[dict] = None,
                  device="cuda") -> np.ndarray:
    """5-stage enhancement of an HWC BGR u8 frame (reference
    frame_enhancer.process_pipeline: color profile -> CLAHE on LAB-L ->
    bilateral -> sharpen -> min-max normalize), on the card by the port's
    CLAHE and bilateral kernels."""
    from chessboard_vision_tpu_torch.models.enhancer import ImageEnhancer

    device = resolve_device(device, "enhance_frame")
    key = (json.dumps(profile, sort_keys=True) if profile else None, str(device))
    if key not in _enhancers:
        _enhancers[key] = ImageEnhancer(profile=profile, device=device)
    return _enhancers[key].process_pipeline(frame)


def extract_grid(frame: np.ndarray, corners, grid_x=None, grid_y=None,
                 device="cuda") -> Dict[SquareTuple, np.ndarray]:
    """Warp the frame to the top-down board and split it into 64 square
    images keyed (file, rank), a1 = (0, 0): reference
    GridExtractor.split_board semantics (linear or smart-grid lines). The
    warp is the cached pipeline's ``warp_board``, the port's gather warp
    (ops/warp.py, an f32 bilinear lerp)."""
    pipe, _ = _pipeline_for(corners, None, device)
    return geo.split_board_dict(pipe.warp_board(frame), grid_x, grid_y)


def _pipeline_for(corners, settings: Optional[dict], device):
    """The cached (pipeline, initial state) of a calibration on a device."""
    device = resolve_device(device, "api")
    key = (
        json.dumps(np.asarray(corners).tolist()),
        json.dumps(settings, sort_keys=True) if settings else None,
        str(device),
    )
    if key not in _pipelines:
        from chessboard_vision_tpu_torch.models.pipeline import VisionPipeline

        g = geo.BoardGeometry.from_calibration(corners)
        pipe = VisionPipeline(g, piece_settings=settings, device=device)
        _pipelines[key] = (pipe, pipe.init_state())
    return _pipelines[key]


def detect_pieces(
    frame: np.ndarray,
    corners,
    reference_frame: Optional[np.ndarray] = None,
    settings: Optional[dict] = None,
    device="cuda",
) -> Set[SquareTuple]:
    """Occupied squares of one HWC BGR frame: the full per-square cascade
    (Hough circle / center-diff / ring symmetry, reference
    piece_detector.detect_all_pieces) in one device step.

    Stateless: temporal smoothing and the delta cache are off. A
    reference_frame, when given, is the visual reference the center-diff
    method compares against."""
    from chessboard_vision_tpu_torch.models.pipeline import occupancy_to_set

    pipe, state = _pipeline_for(corners, settings, device)
    if reference_frame is not None:
        state = pipe.capture_reference(state, reference_frame)
    _, out = pipe.step(state, frame, use_smoothing=False, use_delta=False)
    return occupancy_to_set(out.occupancy)


def detect_changes(
    frame: np.ndarray,
    corners,
    reference_frame: np.ndarray,
    settings: Optional[dict] = None,
    device="cuda",
) -> Set[SquareTuple]:
    """Squares whose content changed against the reference frame (the EMA
    z-score background model, reference change_detector semantics), one
    shot: calibrate on the reference, detect on the frame."""
    pipe, state = _pipeline_for(corners, settings, device)
    state = pipe.capture_reference(state, reference_frame)
    _, out = pipe.step(state, frame, use_smoothing=False, use_delta=False)
    # change_intensity: 0 = none, 1/2/3 = LEVE/PARCIAL/TOTAL.
    changed = (out.change_intensity > 0).cpu().numpy()
    return {(int(i) % 8, int(i) // 8) for i in np.nonzero(changed)[0]}


def frame_to_fen(
    frame: np.ndarray,
    corners,
    reference_frame: Optional[np.ndarray] = None,
    settings: Optional[dict] = None,
    device="cuda",
) -> str:
    """One frame -> occupancy FEN (the placement field uses 'P' per piece)."""
    occ = detect_pieces(frame, corners, reference_frame, settings, device)
    mask = np.zeros((8, 8), bool)
    for f, r in occ:
        mask[f, r] = True
    return occupancy_to_fen(mask)


def frame_to_full_fen(
    frame: np.ndarray,
    corners,
    calibration_frames,
    calibration_board=None,
    frames=None,
    settings: Optional[dict] = None,
    device="cuda",
) -> str:
    """Frame(s) -> FULL FEN placement by the piece-TYPE classifier.

    calibration_frames: one frame (or a list) of a KNOWN position
    (calibration_board, default the initial setup), where the per-type
    centroids are fitted (rules/piece_types.py). frames: optional extra
    frames of the target position to average the features over (detected
    radii jitter a few px a frame). Squares the model cannot type degrade
    to the colored-FEN pawn placeholder."""
    from chessboard_vision_tpu_torch.models.pipeline import outputs_to_numpy
    from chessboard_vision_tpu_torch.rules import chess, classify_piece_colors
    from chessboard_vision_tpu_torch.rules.piece_types import (
        PieceTypeClassifier,
        average_extents,
        average_radii,
        mask_radii_by_method,
        occupancy_to_full_fen,
    )

    if calibration_board is None:
        calibration_board = chess.Board()
    if not isinstance(calibration_frames, (list, tuple)):
        calibration_frames = [calibration_frames]
    target_frames = [frame] + list(frames or [])

    pipe, state = _pipeline_for(corners, settings, device)
    all_sq = {(f, r) for f in range(8) for r in range(8)}

    def features_over(st, frs):
        rads, exts, out = [], [], None
        for fr in frs:
            st, out = pipe.step(st, fr, squares_to_check=all_sq,
                                use_smoothing=False, use_delta=False)
            out = outputs_to_numpy(out)
            rads.append(mask_radii_by_method(out.radius, out.method))
            exts.append(out.profile_extent)
        return st, average_radii(np.stack(rads)), average_extents(np.stack(exts)), out

    state = pipe.capture_reference(state, calibration_frames[0])
    state, cal_radii, cal_extents, _ = features_over(state, calibration_frames)
    clf = PieceTypeClassifier()
    clf.calibrate(cal_radii, calibration_board, extents=cal_extents)

    state = pipe.capture_reference(state, target_frames[0])
    state, radii, extents, out = features_over(state, target_frames)
    occ = out.occupancy
    colors = classify_piece_colors(out.center_mean, occ, out.corner_mean)
    chars = clf.classify(radii, occ, colors, extents=extents)
    return occupancy_to_full_fen(occ.reshape(8, 8).T, chars, piece_colors=colors)


def digitize_video(
    video_path: str,
    corners=None,
    config: Optional[dict] = None,
    skip_frames: int = 2,
    max_frames: Optional[int] = None,
    auto_recalibrate: bool = False,
    pgn_headers: Optional[dict] = None,
    device="cuda",
) -> dict:
    """One-call recorded-footage digitizer: video file -> moves/FEN/PGN.

    Wraps tools/process_video.run and rules.pgn.game_to_pgn. Pass either
    the 4 calibration ``corners`` (TL, TR, BL, BR) or a full calibration
    ``config`` dict. Returns {"moves": [uci...], "fen": str, "pgn": str,
    "frames": int}. ``auto_recalibrate`` turns on the session's drift
    re-calibration (session/drift.py)."""
    from chessboard_vision_tpu_torch.rules.pgn import game_to_pgn
    from chessboard_vision_tpu_torch.tools.process_video import run

    if config is None:
        if corners is None:
            raise ValueError("pass corners or a calibration config")
        config = {
            "corners": np.asarray(corners).tolist(),
            "player_color": "white",
            "orientation_flipped": False,
        }
    if auto_recalibrate:
        config = {**config, "auto_recalibrate": True}
    moves, fen, n = run(video_path, config, skip_frames=skip_frames, max_frames=max_frames,
                        device=device)
    return {
        "moves": list(moves),
        "fen": fen,
        # claim_draws: the recording is the whole game, so a final
        # claimable-draw position is the game's actual ending.
        "pgn": game_to_pgn(moves, headers=pgn_headers, claim_draws=True),
        "frames": n,
    }
