"""GameSession: per-frame orchestration, stability gating, move inference.

Counterpart of the main-path part of chessboard_vision_tpu.session.
game_session (reference game_session.py): ``on_frame`` runs one pipeline
step on the session's device, reads the 64 per-square outputs back in one
copy, then runs the host control plane: noise FSM, occupancy-stability gate
(20 frames / 2 s cooldown / >4-diff reset), legal-move inference with
ambiguity rejection, and the ``on_move_detected`` subclass hook.
``board_lock`` (RLock) is held across inference and push, as in the
reference. Each ``on_frame`` is one call of utils/profiling.py's call
table: its span ``session.on_frame`` holds ``session.smart_scan``, the
pipeline's spans, ``session.device_wait`` (the one wait for the card: the
step and the packing of its outputs, before their D2H copy) and
``session.rules``.

``save_checkpoint``/``resume_checkpoint`` snapshot the session mid-game
in the JAX package's checkpoint format (utils/checkpoint.py), so a
checkpoint of either package resumes in the other.

Recorded sources: ``cooldown_frames`` counts the post-move cooldown in
processed frames instead of wall seconds (tools/process_video.py sets it
from the file's FPS). Piece types: ``on_frame`` keeps 8-deep windows of
the method-masked radii and the ring-coverage extents of frames that agree
with the rules board; ``calibrate_piece_types`` fits the type model on the
current (known) position, ``full_fen`` reads the placement off the board
and ``verify_position`` holds it against the rules board.

Drift re-calibration (``"auto_recalibrate": true``, session/drift.py):
every ``drift_check_interval`` frames the automatic corner detector runs on
the frame (its image stages on the session's device); a confirmed camera
bump rebuilds the geometry and the pipeline around the shifted corners and
re-captures the references, the game kept (``_recalibrate``).

The UI: every frame ``_update_radar_ui`` sets the lifted piece and its
legal destinations (``lifted_piece_square``, ``current_radar_destinations``)
under ``board_lock``; with ``headless=False`` ``_draw_interface`` shows the
warped board with the overlay of session/renderer.py ("Board") and the
camera frame ("Camera") in cv2's windows. ``headless`` defaults to True
here, where the JAX package's GameSession defaults to False: the card's
machine has no display and no cv2. ``on_calibration_requested`` with a
camera and no saved calibration opens the interactive calibration tool
(tools/calibration_module.py) on ``gui``, cv2's HighGUI by default.
``compat_visual_rank_quirk`` keeps the reference's smart-scan quirk.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from chessboard_vision_tpu_torch import geometry as geo
from chessboard_vision_tpu_torch.device import resolve_device, synchronize
from chessboard_vision_tpu_torch.rules import GameState, chess, classify_piece_colors
from chessboard_vision_tpu_torch.rules.piece_types import (
    PieceTypeClassifier,
    average_extents,
    average_radii,
    mask_radii_by_method,
    occupancy_to_full_fen,
)
from chessboard_vision_tpu_torch.utils.config import (
    CALIBRATION_FILE,
    COLOR_PROFILE_FILE,
    PIECE_SETTINGS_FILE,
    SENSITIVITY_FILE,
    load_json_config,
)
from chessboard_vision_tpu_torch.utils.checkpoint import load_tree, read_meta, save_tree
from chessboard_vision_tpu_torch.utils.logging import get_logger
from chessboard_vision_tpu_torch.utils.profiling import FpsCounter, span
from chessboard_vision_tpu_torch.models.pipeline import (
    StepOutputs,
    VisionPipeline,
    occupancy_to_set,
    pack_leaves,
    unpack_leaves,
)
from chessboard_vision_tpu_torch.session.drift import DriftMonitor
from chessboard_vision_tpu_torch.session.inference import infer_move_from_diff
from chessboard_vision_tpu_torch.session.noise import NoiseHandler, NoiseState
from chessboard_vision_tpu_torch.session.renderer import draw_board_overlay
from chessboard_vision_tpu_torch.tools.calibration_module import CalibrationModule


class GameSession:
    STABILITY_REQUIRED = 20  # stable frames before committing a move
    MOVE_COOLDOWN = 2.0  # seconds after a committed move
    FULL_SCAN_PERIOD = 30  # full 64-square scan every Nth frame

    def __init__(self, device="cuda", hough_backend: str = "auto", headless: bool = True,
                 compat_visual_rank_quirk: bool = False):
        """``hough_backend`` goes to the VisionPipeline: "auto" is exact on a
        CPU device and conv on the card. ``headless=False`` draws the board
        overlay in cv2's windows every frame. ``compat_visual_rank_quirk``
        adds legal-move destinations to the smart-scan set with the visual
        rank (7 - rank), as the reference did (game_session.py:151-154)."""
        self.device = resolve_device(device, "GameSession")
        self.hough_backend = hough_backend
        self.headless = headless
        self.compat_visual_rank_quirk = compat_visual_rank_quirk
        self.board_lock = threading.RLock()

        self.config: Optional[dict] = None
        # Keys merged over any calibration config at configure() time: the
        # CLI drivers' hook for flags like --auto-recalibrate.
        self.default_config_overrides: dict = {}
        self.pipeline: Optional[VisionPipeline] = None
        self.pipe_state = None
        self.game: Optional[GameState] = None
        self.noise: Optional[NoiseHandler] = None
        self.player_color = None
        self.orientation_flipped = False
        self.drift: Optional[DriftMonitor] = None
        self.drift_check_interval = 300

        self.fps = FpsCounter()
        self.frame_count = 0
        self.stable_occupancy = None
        self.stable_count = 0
        self.last_move_time = 0.0
        self.last_move_frame = -(10**9)
        # Post-move cooldown in processed frames (None: MOVE_COOLDOWN wall
        # seconds). A recorded source runs faster than real time, where a
        # wall-clock cooldown drops moves: process_video sets this from the
        # file's FPS.
        self.cooldown_frames: Optional[int] = None
        self.last_outputs = None  # the last step's StepOutputs, host numpy
        self.lifted_piece_square = None  # (file, rank) of a lifted piece of the side to move
        self.current_radar_destinations = []  # its legal destinations
        self._refresh_next = False
        # Piece types (rules/piece_types.py): radii and extents of frames
        # whose occupancy matches the rules board, reset when the expected
        # position changes.
        self._radius_window = deque(maxlen=8)
        self._extent_window = deque(maxlen=8)
        self._radius_window_occ = None
        self._types_updated_here = False
        self.piece_types: Optional[PieceTypeClassifier] = None
        self.log = get_logger("session")

    # -- calibration -----------------------------------------------------

    def on_calibration_requested(self, cap=None, config: Optional[dict] = None,
                                 gui=None) -> bool:
        """Calibrate from a config dict, else from a saved calibration.json,
        else, given a camera, from the interactive calibration tool on
        ``gui`` (cv2's HighGUI when None; tools/calibration_module.py); then
        capture the reference from ``cap`` (any reader with ``read()``)
        when one is given."""
        if config is None:
            config = load_json_config(CALIBRATION_FILE)
        if config is None and cap is not None:
            config = CalibrationModule(gui=gui, device=self.device).run(cap)
        if config is None:
            return False
        self.configure(config)
        if cap is not None:
            self.capture_reference(cap)
        return True

    def configure(self, config: dict):
        """Build the pipeline and control-plane components from calibration,
        with ``default_config_overrides`` merged over it.
        ``"use_enhancer": true`` puts the 5-stage enhancement ahead of
        detection in the same step, with the color profile of
        ``config["enhancer_profile"]`` or, failing that, color_profile.json.
        ``"auto_recalibrate": true`` runs the drift check every
        ``"drift_check_interval"`` frames (default 300) with the gates
        ``"drift_threshold_px"``, ``"drift_max_px"`` and
        ``"drift_confirm_checks"`` (session/drift.py)."""
        if self.default_config_overrides:
            config = {**config, **self.default_config_overrides}
        self.config = config
        self.player_color = config.get("player_color")
        self.orientation_flipped = config.get("orientation_flipped", False)
        geometry = geo.BoardGeometry.from_config(config)
        use_enhancer = bool(config.get("use_enhancer", False))
        enhancer_profile = None
        if use_enhancer:
            enhancer_profile = config.get("enhancer_profile")
            if enhancer_profile is None:
                enhancer_profile = load_json_config(COLOR_PROFILE_FILE)
        self._pipeline_kwargs = dict(
            piece_settings=load_json_config(PIECE_SETTINGS_FILE),
            change_settings=load_json_config(SENSITIVITY_FILE),
            with_enhancer=use_enhancer,
            enhancer_profile=enhancer_profile,
            hough_backend=self.hough_backend,
            device=self.device,
        )
        self.pipeline = VisionPipeline(geometry, **self._pipeline_kwargs)
        self.pipe_state = self.pipeline.init_state()
        self.game = GameState()
        self.noise = NoiseHandler()
        self.drift = None
        self.drift_check_interval = int(config.get("drift_check_interval", 300))
        if config.get("auto_recalibrate", False):
            self.drift = DriftMonitor(
                np.asarray(config["corners"], np.float64).reshape(4, 2),
                threshold_px=float(config.get("drift_threshold_px", 4.0)),
                max_px=float(config.get("drift_max_px", 80.0)),
                confirm=int(config.get("drift_confirm_checks", 2)),
                device=self.device,
            )

    def capture_reference(self, cap, warmup: int = 10):
        """Capture the initial visual reference from a camera-like reader
        after ``warmup`` frames (reference game_session.py:93)."""
        for _ in range(warmup):
            cap.read()
        ok, img = cap.read()
        if ok:
            self.capture_reference_frame(img)

    def capture_reference_frame(self, img: np.ndarray):
        """Capture the visual reference from one frame; with drift checks
        on, the frame also seeds the detector's baseline, so a bump before
        the first periodic check is still caught."""
        self.pipe_state = self.pipeline.capture_reference(self.pipe_state, img)
        if self.drift is not None:
            self.drift.check(img)
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
                squares.add((f, 7 - r) if self.compat_visual_rank_quirk else (f, r))
        return squares

    def on_frame(self, img: np.ndarray):
        """Process one camera frame; returns the committed move or None."""
        with span("session.on_frame"):
            self.frame_count += 1
            self.fps.update()
            squares_to_check = None
            if self.frame_count % self.FULL_SCAN_PERIOD != 0 and self.game is not None:
                with span("session.smart_scan"):
                    squares_to_check = self._smart_scan_set()

            refresh = self._refresh_next
            self._refresh_next = False
            self.pipe_state, out = self.pipeline.step(
                self.pipe_state, img, squares_to_check=squares_to_check, refresh_refs=refresh
            )
            packed = pack_leaves(out)  # queued behind the step
            with span("session.device_wait"):
                synchronize(packed.device)
            out = StepOutputs(*unpack_leaves(packed.cpu().numpy(), out))
            self.last_outputs = out
            vision_occupied = occupancy_to_set(out.occupancy)
            visual_changes = occupancy_to_set(out.visual_changes)

            noise_state, _ = self.noise.process(visual_changes)
            self._update_radar_ui(vision_occupied)
            self._track_radii(vision_occupied, out)
            with span("session.rules"):
                move = self._process_stable_move(vision_occupied, noise_state)

            # The drift check is not gated on the noise FSM: a real bump keeps
            # the FSM NOISE_ACTIVE (the shifted content never settles), which
            # would block the very check that heals it; the monitor's own gates
            # reject a hand over the board.
            if self.drift is not None and self.frame_count % self.drift_check_interval == 0:
                new_corners = self.drift.check(img)
                if new_corners is not None:
                    self._recalibrate(new_corners, img)
            if not self.headless:
                self._draw_interface(img, noise_state)
            return move

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
            if self.cooldown_frames is not None:
                cooldown_ok = (self.frame_count - self.last_move_frame) > self.cooldown_frames
            else:
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
                            self.last_move_frame = self.frame_count
                            # Forced re-reference inside the next frame's step.
                            self._refresh_next = True
                            self.noise.reset()
                            self.stable_count = 0
                            return move
                        self.log.critical("move %s became illegal before push", move.uci())
        return None

    def _recalibrate(self, corners: np.ndarray, frame: np.ndarray):
        """Rebuild geometry and pipeline around shifted corners, mid-game.

        Unlike configure(), the GAME is kept: a new VisionPipeline of the
        same kind on the same device, references re-captured from this
        frame, and the noise, stability and radius windows reset so that no
        phantom move commits across the boundary. Smart-grid lines are
        kept: they live in warped-board space, which the new homography
        maps the same physical board onto."""
        with self.board_lock:
            self.config["corners"] = np.rint(np.asarray(corners)).astype(int).tolist()
            geometry = geo.BoardGeometry.from_config(self.config)
            self.pipeline = VisionPipeline(geometry, **self._pipeline_kwargs)
            self.pipe_state = self.pipeline.capture_reference(self.pipeline.init_state(), frame)
            self.noise.reset()
            self.stable_count = 0
            self.stable_occupancy = None
            self._radius_window.clear()
            self._extent_window.clear()
            self._refresh_next = False
            self.log.warning("auto-recalibrated to shifted corners; game preserved")

    def _infer_move(self, diff_missing, diff_extra, vision_occupied):
        """Infer one legal move from occupancy diffs (game_session.py:227-265)."""
        return infer_move_from_diff(
            self.game, diff_missing, diff_extra, vision_occupied, log=self.log
        )

    def on_move_detected(self, move) -> bool:
        """Subclass hook; True accepts the move locally."""
        return True

    # -- piece-type classification (full FEN from vision) ----------------

    def _track_radii(self, vision_occupied, out):
        """Accumulate per-square (radius, extent) features of frames whose
        occupancy matches the rules board; the windows reset when the
        expected position changes. Radii are masked by cascade method (only
        Hough-family squares measured a circle). Once a position fills the
        window, the type model (if calibrated) takes its rules-labeled
        samples (PieceTypeClassifier.update)."""
        with self.board_lock:
            expected = self.game.get_board_occupancy()
        if expected != self._radius_window_occ:
            self._radius_window.clear()
            self._extent_window.clear()
            self._radius_window_occ = set(expected)
            self._types_updated_here = False
        if vision_occupied == expected:
            self._radius_window.append(mask_radii_by_method(out.radius, out.method))
            self._extent_window.append(np.asarray(out.profile_extent))
        if (
            self.piece_types is not None
            and not self._types_updated_here
            and len(self._radius_window) == self._radius_window.maxlen
        ):
            with self.board_lock:
                self.piece_types.update(
                    average_radii(np.stack(self._radius_window)),
                    self.game.board,
                    extents=average_extents(np.stack(self._extent_window)),
                )
            self._types_updated_here = True

    def calibrate_piece_types(self):
        """Fit the piece-type model on the CURRENT (known) position, e.g.
        the initial setup after capture_reference, where all 12 classes
        are visible. Returns the radius-centroid dict, or None when no
        frame agreeing with the rules board has been seen yet."""
        if not self._radius_window:
            return None
        clf = PieceTypeClassifier()
        with self.board_lock:
            clf.calibrate(
                average_radii(np.stack(self._radius_window)),
                self.game.board,
                extents=average_extents(np.stack(self._extent_window)),
            )
        self.piece_types = clf
        return clf.centroids

    def full_fen(self):
        """The FULL FEN placement read from vision (piece types from the
        type model), independent of the rules board. None until
        calibrate_piece_types has run and the window holds frames."""
        if self.piece_types is None or self.last_outputs is None or not self._radius_window:
            return None
        out = self.last_outputs
        occ = np.asarray(out.occupancy)
        colors = classify_piece_colors(
            np.asarray(out.center_mean), occ, np.asarray(out.corner_mean)
        )
        chars = self.piece_types.classify(
            average_radii(np.stack(self._radius_window)), occ, colors,
            extents=average_extents(np.stack(self._extent_window)),
        )
        return occupancy_to_full_fen(occ.reshape(8, 8).T, chars, piece_colors=colors)

    def verify_position(self):
        """(match, got, want): the vision full-FEN placement against the
        rules board's, at piece-type granularity; (None, None, want) while
        the type model is not ready."""
        with self.board_lock:
            want = self.game.get_fen().split()[0]
        got = self.full_fen()
        if got is None:
            return None, None, want
        got = got.split()[0]
        return got == want, got, want

    # -- UI ---------------------------------------------------------------

    def _update_radar_ui(self, vision_occupied):
        """The lifted piece and its legal destinations: set when exactly one
        square of the rules board is empty in vision and holds a piece of
        the side to move. Under board_lock: legal-move generation makes and
        unmakes moves on the board the Lichess stream thread also syncs."""
        with self.board_lock:
            lifted = self.game.get_board_occupancy() - vision_occupied
            self.lifted_piece_square = None
            self.current_radar_destinations = []
            if len(lifted) == 1:
                pos = next(iter(lifted))
                sq = chess.square(pos[0], pos[1])
                piece = self.game.board.piece_at(sq)
                if piece and piece.color == self.game.board.turn:
                    self.lifted_piece_square = pos
                    for move in self.game.board.legal_moves:
                        if move.from_square == sq:
                            self.current_radar_destinations.append(
                                (chess.square_file(move.to_square),
                                 chess.square_rank(move.to_square)))

    def _draw_interface(self, img_raw, noise_state):
        """Show the warped board with the session's overlay ("Board") and
        the camera frame ("Camera") in cv2's windows."""
        import cv2

        geometry = self.pipeline.geometry
        vis = draw_board_overlay(
            self.pipeline.warp_board(img_raw),
            board_size=geometry.board_size,
            grid_x=geometry.grid_x,
            grid_y=geometry.grid_y,
            game=self.game,
            board_lock=self.board_lock,
            noise_active=noise_state == NoiseState.NOISE_ACTIVE,
            lifted=self.lifted_piece_square,
            radar=self.current_radar_destinations,
            fps=self.fps.fps,
            clock_text=self.clock_hud(),
        )
        cv2.imshow("Board", vis)
        cv2.imshow("Camera", img_raw)

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

    def clock_hud(self) -> str:
        """Clock HUD line; sessions with a clock source override this."""
        return ""

    def on_exit(self):
        """Called by the drivers when the session ends; a subclass stops
        its background work here."""
