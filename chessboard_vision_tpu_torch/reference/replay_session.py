"""Oracle replay session: the full cv2 decision loop over recorded frames.

Counterpart of chessboard_vision_tpu.reference.replay_session. It
operationalizes the reference's real-footage validation path
(test_piece_detector.py:49-116 — a human watching live-webcam detections)
as a machine-checkable replay: the same frames a GameSession processed are
driven through the cv2 oracle backends (warp -> split -> PieceDetectorCV)
with the SAME decision gating (smart scan, noise FSM, 20-frame stability,
move inference), so `process_video --compare-oracle` can emit a
decision-agreement report for any user-supplied video instead of asking
them to hand-wire the oracles of reference/ themselves.

The loop mirrors session/game_session.py constants and ordering; each side
runs INDEPENDENTLY (its own game state feeds its own smart-scan set), so
the comparison is between two complete frame->moves digitizations, not a
single pipeline with swapped kernels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from chessboard_vision_tpu_torch.geometry import reorder, warp_matrix, linear_grid_lines
from chessboard_vision_tpu_torch.reference.piece_detector import PieceDetectorCV
from chessboard_vision_tpu_torch.rules import chesslib as chess
from chessboard_vision_tpu_torch.rules.game_state import GameState
from chessboard_vision_tpu_torch.session.inference import infer_move_from_diff
from chessboard_vision_tpu_torch.session.noise import NoiseHandler, NoiseState
from chessboard_vision_tpu_torch.utils.logging import get_logger


class OracleReplaySession:
    """cv2-oracle twin of GameSession's per-frame decision loop.

    Same gates as session/game_session.py (FULL_SCAN_PERIOD=30 smart scan,
    >4-diff stability reset, STABILITY_REQUIRED=20, noise-FSM block,
    frame-based post-move cooldown, shared move inference); vision runs on
    the declared oracle backends instead of the port's pipeline.
    """

    FULL_SCAN_PERIOD = 30
    STABILITY_REQUIRED = 20

    def __init__(
        self,
        config: dict,
        cooldown_frames: Optional[int] = None,
        compat_visual_rank_quirk: bool = False,
    ):
        import cv2

        display_size = tuple(config.get("display_size") or (1280, 720))
        pts = reorder(np.asarray(config["corners"]))
        self.M, self.bs = warp_matrix(pts, display_size)
        self.orientation_flipped = bool(config.get("orientation_flipped", False))
        gx = config.get("grid_lines_x")
        gy = config.get("grid_lines_y")
        self.grid_x = list(gx) if gx else linear_grid_lines(self.bs)
        self.grid_y = list(gy) if gy else linear_grid_lines(self.bs)
        self._cv2 = cv2

        self.det = PieceDetectorCV()
        self.game = GameState()
        self.noise = NoiseHandler()
        self.cooldown_frames = cooldown_frames
        self.compat_visual_rank_quirk = compat_visual_rank_quirk

        self.frame_count = 0
        self.stable_occupancy: Optional[set] = None
        self.stable_count = 0
        self.last_move_frame = -(10**9)
        self.moves: list = []
        self.last_occupancy: set = set()
        self.log = get_logger("oracle_replay")

    # -- vision ------------------------------------------------------------

    def _warp(self, frame: np.ndarray) -> np.ndarray:
        warped = self._cv2.warpPerspective(frame, self.M, (self.bs, self.bs))
        if self.orientation_flipped:
            warped = self._cv2.rotate(warped, self._cv2.ROTATE_180)
        return warped

    def _split(self, warped: np.ndarray) -> dict:
        """(file, rank)-keyed square crops; honors smart-grid lines when
        the calibration carries them (reference grid_extractor.py:123-163),
        else the linear 8x8 split."""
        out = {}
        for row in range(8):  # row 0 = rank 8 visually
            y0, y1 = int(self.grid_y[row]), int(self.grid_y[row + 1])
            for col in range(8):
                x0, x1 = int(self.grid_x[col]), int(self.grid_x[col + 1])
                out[(col, 7 - row)] = warped[y0:y1, x0:x1]
        return out

    def capture_reference(self, frame: np.ndarray) -> None:
        self.det.update_references(self._split(self._warp(frame)))

    # -- decision loop (mirrors GameSession.on_frame) -----------------------

    def _smart_scan_set(self) -> set:
        squares = set(self.game.get_board_occupancy())
        for move in self.game.board.legal_moves:
            f = chess.square_file(move.to_square)
            r = chess.square_rank(move.to_square)
            squares.add((f, 7 - r) if self.compat_visual_rank_quirk else (f, r))
        return squares

    def on_frame(self, img: np.ndarray):
        """Process one frame; returns the committed Move or None."""
        self.frame_count += 1
        squares_to_check = None
        if self.frame_count % self.FULL_SCAN_PERIOD != 0:
            squares_to_check = self._smart_scan_set()

        squares = self._split(self._warp(img))
        results, visual_changes = self.det.detect_all_pieces(
            squares, use_delta=True, squares_to_check=squares_to_check
        )
        occupied = {pos for pos, info in results.items() if info["has_piece"]}
        self.last_occupancy = occupied
        noise_state, _ = self.noise.process(visual_changes)

        expected = self.game.get_board_occupancy()
        diff_missing = expected - occupied
        diff_extra = occupied - expected
        if len(diff_missing) + len(diff_extra) > 4:
            self.stable_count = 0
            self.stable_occupancy = set()
        elif self.stable_occupancy == occupied:
            self.stable_count += 1
        else:
            self.stable_occupancy = set(occupied)
            self.stable_count = 1

        cooldown_ok = (
            self.cooldown_frames is None
            or (self.frame_count - self.last_move_frame) > self.cooldown_frames
        )
        if (
            self.stable_count >= self.STABILITY_REQUIRED
            and cooldown_ok
            and noise_state != NoiseState.NOISE_ACTIVE
        ):
            move = infer_move_from_diff(
                self.game, diff_missing, diff_extra, occupied, log=self.log
            )
            if move and move in self.game.board.legal_moves:
                self.game.board.push(move)
                self.moves.append(move.uci())
                self.last_move_frame = self.frame_count
                self.det.update_references(squares)
                self.noise.reset()
                self.stable_count = 0
                return move
        return None

    def get_fen(self) -> str:
        return self.game.get_fen()


def agreement_report(
    tpu_moves,
    tpu_fen: str,
    oracle: OracleReplaySession,
    per_frame_matches: list,
) -> dict:
    """Decision-agreement summary between a GameSession run and the
    oracle replay: per-frame occupancy agreement (per-square fraction and
    fully-agreeing-frame fraction), move-list diff, and FEN match."""
    n = len(per_frame_matches)
    sq_frac = float(np.mean(per_frame_matches)) if n else 1.0
    full = sum(1 for m in per_frame_matches if m == 64) / n if n else 1.0
    tpu_moves = list(tpu_moves)
    omoves = list(oracle.moves)
    first_div = next(
        (i for i, (a, b) in enumerate(zip(tpu_moves, omoves)) if a != b),
        None,
    )
    if first_div is None and len(tpu_moves) != len(omoves):
        first_div = min(len(tpu_moves), len(omoves))
    return {
        "frames_compared": n,
        "square_agreement_pct": round(100.0 * sq_frac / 64.0, 3),
        "frame_full_agreement_pct": round(100.0 * full, 3),
        "tpu_moves": tpu_moves,
        "oracle_moves": omoves,
        "move_lists_match": tpu_moves == omoves,
        "first_divergent_move": first_div,
        "tpu_final_fen": tpu_fen,
        "oracle_final_fen": oracle.get_fen(),
        "fen_match": tpu_fen == oracle.get_fen(),
    }
