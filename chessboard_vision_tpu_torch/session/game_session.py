"""GameSession: per-frame orchestration, stability gating, move inference.

Counterpart of the main-path part of chessboard_vision_tpu.session.
game_session (reference game_session.py): ``on_frame`` runs one pipeline
step on the session's device, reads the 64 per-square outputs back in one
copy, then runs the host control plane: noise FSM, occupancy-stability gate
(20 frames / 2 s cooldown / >4-diff reset), legal-move inference with
ambiguity rejection, and the ``on_move_detected`` subclass hook.
``board_lock`` (RLock) is held across inference and push, as in the
reference.

``save_checkpoint``/``resume_checkpoint`` snapshot the session mid-game
in the JAX package's checkpoint format (utils/checkpoint.py), so a
checkpoint of either package resumes in the other.

Not ported yet (ROADMAP.md Queue A): drift re-calibration, the renderer/UI
overlay, piece-type classification, the frame-counted cooldown of recorded
sources and the reference's visual-rank scan quirk.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from chessboard_vision_tpu_torch import geometry as geo
from chessboard_vision_tpu_torch.device import resolve_device
from chessboard_vision_tpu_torch.rules import GameState, chess
from chessboard_vision_tpu_torch.utils.config import (
    CALIBRATION_FILE,
    COLOR_PROFILE_FILE,
    PIECE_SETTINGS_FILE,
    SENSITIVITY_FILE,
    load_json_config,
)
from chessboard_vision_tpu_torch.utils.checkpoint import load_tree, read_meta, save_tree
from chessboard_vision_tpu_torch.utils.logging import get_logger
from chessboard_vision_tpu_torch.models.pipeline import (
    VisionPipeline,
    occupancy_to_set,
    outputs_to_numpy,
)
from chessboard_vision_tpu_torch.session.inference import infer_move_from_diff
from chessboard_vision_tpu_torch.session.noise import NoiseHandler, NoiseState


class GameSession:
    STABILITY_REQUIRED = 20  # stable frames before committing a move
    MOVE_COOLDOWN = 2.0  # seconds after a committed move
    FULL_SCAN_PERIOD = 30  # full 64-square scan every Nth frame

    def __init__(self, device="cuda", hough_backend: str = "auto"):
        """``hough_backend`` goes to the VisionPipeline: "auto" is exact on a
        CPU device and conv on the card."""
        self.device = resolve_device(device, "GameSession")
        self.hough_backend = hough_backend
        self.board_lock = threading.RLock()

        self.config: Optional[dict] = None
        self.pipeline: Optional[VisionPipeline] = None
        self.pipe_state = None
        self.game: Optional[GameState] = None
        self.noise: Optional[NoiseHandler] = None
        self.player_color = None

        self.frame_count = 0
        self.stable_occupancy = None
        self.stable_count = 0
        self.last_move_time = 0.0
        self._refresh_next = False
        self.log = get_logger("session")

    # -- calibration -----------------------------------------------------

    def on_calibration_requested(self, config: Optional[dict] = None) -> bool:
        """Calibrate from a config dict, else from a saved calibration.json.
        (The camera-driven calibration tool is not ported yet: ROADMAP A15.)"""
        if config is None:
            config = load_json_config(CALIBRATION_FILE)
        if config is None:
            return False
        self.configure(config)
        return True

    def configure(self, config: dict):
        """Build the pipeline and control-plane components from calibration.
        ``"use_enhancer": true`` puts the 5-stage enhancement ahead of
        detection in the same step, with the color profile of
        ``config["enhancer_profile"]`` or, failing that, color_profile.json."""
        self.config = config
        self.player_color = config.get("player_color")
        geometry = geo.BoardGeometry.from_config(config)
        use_enhancer = bool(config.get("use_enhancer", False))
        enhancer_profile = None
        if use_enhancer:
            enhancer_profile = config.get("enhancer_profile")
            if enhancer_profile is None:
                enhancer_profile = load_json_config(COLOR_PROFILE_FILE)
        self.pipeline = VisionPipeline(
            geometry,
            piece_settings=load_json_config(PIECE_SETTINGS_FILE),
            change_settings=load_json_config(SENSITIVITY_FILE),
            with_enhancer=use_enhancer,
            enhancer_profile=enhancer_profile,
            hough_backend=self.hough_backend,
            device=self.device,
        )
        self.pipe_state = self.pipeline.init_state()
        self.game = GameState()
        self.noise = NoiseHandler()

    def capture_reference_frame(self, img: np.ndarray):
        """Capture the initial visual reference (reference game_session.py:93)."""
        self.pipe_state = self.pipeline.capture_reference(self.pipe_state, img)
        self.log.info("reference captured; game ready")

    # -- per-frame hot path ----------------------------------------------

    def _smart_scan_set(self):
        """Occupied squares + legal-move destinations (game_session.py:130-154)."""
        squares = set()
        with self.board_lock:
            squares.update(self.game.get_board_occupancy())
            for move in self.game.board.legal_moves:
                f = chess.square_file(move.to_square)
                r = chess.square_rank(move.to_square)
                squares.add((f, r))
        return squares

    def on_frame(self, img: np.ndarray):
        """Process one camera frame; returns the committed move or None."""
        self.frame_count += 1
        squares_to_check = None
        if self.frame_count % self.FULL_SCAN_PERIOD != 0 and self.game is not None:
            squares_to_check = self._smart_scan_set()

        refresh = self._refresh_next
        self._refresh_next = False
        self.pipe_state, out = self.pipeline.step(
            self.pipe_state, img, squares_to_check=squares_to_check, refresh_refs=refresh
        )
        out = outputs_to_numpy(out)
        vision_occupied = occupancy_to_set(out.occupancy)
        visual_changes = occupancy_to_set(out.visual_changes)

        noise_state, _ = self.noise.process(visual_changes)
        return self._process_stable_move(vision_occupied, noise_state)

    # -- stability + inference -------------------------------------------

    def _process_stable_move(self, vision_occupied, noise_state):
        with self.board_lock:
            expected = self.game.get_board_occupancy()
            diff_missing = expected - vision_occupied
            diff_extra = vision_occupied - expected
            total_diff = len(diff_missing) + len(diff_extra)

            if total_diff > 4:  # too much change: probable hand/noise
                self.stable_count = 0
                self.stable_occupancy = set()
            elif self.stable_occupancy == vision_occupied:
                self.stable_count += 1
            else:
                self.stable_occupancy = set(vision_occupied)
                self.stable_count = 1

            now = time.time()
            cooldown_ok = (now - self.last_move_time) > self.MOVE_COOLDOWN
            if (
                self.stable_count >= self.STABILITY_REQUIRED
                and cooldown_ok
                and noise_state != NoiseState.NOISE_ACTIVE
            ):
                move = self._infer_move(diff_missing, diff_extra, vision_occupied)
                if move:
                    self.log.info("robust move detected: %s", move.uci())
                    if self.on_move_detected(move):
                        if move in self.game.board.legal_moves:
                            self.game.board.push(move)
                            self.last_move_time = now
                            # Forced re-reference inside the next frame's step.
                            self._refresh_next = True
                            self.noise.reset()
                            self.stable_count = 0
                            return move
                        self.log.critical("move %s became illegal before push", move.uci())
        return None

    def _infer_move(self, diff_missing, diff_extra, vision_occupied):
        """Infer one legal move from occupancy diffs (game_session.py:227-265)."""
        return infer_move_from_diff(
            self.game, diff_missing, diff_extra, vision_occupied, log=self.log
        )

    def on_move_detected(self, move) -> bool:
        """Subclass hook; True accepts the move locally."""
        return True

    # -- checkpoint / resume ---------------------------------------------

    def save_checkpoint(self, path: str):
        """Snapshot the session mid-game: the pipeline's device state
        (visual references, EMA background model, detection history) and
        the host state (board FEN, noise FSM, stability gate, config)."""
        with self.board_lock:
            meta = {
                "fen": self.game.get_fen(),
                "config": self.config,
                "frame_count": self.frame_count,
                "stable_count": self.stable_count,
                "stable_occupancy": (
                    sorted(self.stable_occupancy)
                    if self.stable_occupancy is not None
                    else None
                ),
                "noise": {
                    "state": self.noise.state.name,
                    "stable_count": self.noise.stable_count,
                    "cooldown_count": self.noise.cooldown_count,
                    "pending_squares": sorted(self.noise.pending_squares),
                    "last_lifted_square": self.noise.last_lifted_square,
                },
            }
            save_tree(path, self.pipe_state, meta)
        self.log.info("checkpoint saved: %s", path)

    def resume_checkpoint(self, path: str) -> dict:
        """Restore a save_checkpoint snapshot, building the pipeline from
        the stored config when this session is not configured yet."""
        if self.pipeline is None:
            self.configure(read_meta(path)["config"])
        with self.board_lock:
            self.pipe_state, meta = load_tree(path, self.pipeline.init_state(), self.device)
            self.game.set_fen(meta["fen"])
            self.frame_count = meta["frame_count"]
            self.stable_count = meta["stable_count"]
            self.stable_occupancy = (
                set(map(tuple, meta["stable_occupancy"]))
                if meta["stable_occupancy"] is not None
                else None
            )
            n = meta["noise"]
            self.noise.state = NoiseState[n["state"]]
            self.noise.stable_count = n["stable_count"]
            self.noise.cooldown_count = n["cooldown_count"]
            self.noise.pending_squares = set(map(tuple, n["pending_squares"]))
            self.noise.last_lifted_square = (
                tuple(n["last_lifted_square"])
                if n["last_lifted_square"] is not None
                else None
            )
        self.log.info("checkpoint resumed: %s (FEN %s)", path, meta["fen"])
        return meta

    def to_pgn(self, headers=None, comments=None, result=None,
               claim_draws=False) -> str:
        """The digitized game as a PGN document (rules/pgn.py)."""
        from chessboard_vision_tpu_torch.rules.chesslib import STARTING_FEN
        from chessboard_vision_tpu_torch.rules.pgn import game_to_pgn

        with self.board_lock:
            moves = [m.uci() for m in self.game.board.move_stack]
            tags = {"White": "?", "Black": "?"}
            if self.player_color:
                tags[self.player_color.capitalize()] = "chessboard_vision_tpu"
            if headers:
                tags.update(headers)
            start = self.game.start_fen
            return game_to_pgn(
                moves, headers=tags,
                start_fen=None if start == STARTING_FEN else start,
                result=result, comments=comments, claim_draws=claim_draws,
            )
