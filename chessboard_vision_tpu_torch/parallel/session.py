"""MultiStreamSession: N concurrent game sessions on one batched pipeline.

Counterpart of chessboard_vision_tpu.parallel.session. N camera rigs are
digitized by one N-stream step per tick (parallel/multistream.py: vision,
change model and the device noise FSM); this wrapper keeps N independent
host rule states (move inference, stability gating, per-stream callbacks)
and feeds smart-scan masks and post-move re-references back per stream.
Per-stream semantics match GameSession (same stability constants and
inference); the noise FSM runs on the device (ops/fsm.py).

``save_checkpoint``/``resume_checkpoint`` use the JAX package's format, so
a checkpoint of either package resumes in the other.
``auto_recalibrate=True`` gives every rig a DriftMonitor (session/drift.py)
checked every ``drift_check_interval`` ticks; the rigs confirmed bumped in
a tick get their shifted corners in ONE rebuild of the pipeline in
per-stream-geometry mode, and only their device state is replaced.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from chessboard_vision_tpu_torch.models.pipeline import occupancy_to_set
from chessboard_vision_tpu_torch.ops.layout import positions_to_mask
from chessboard_vision_tpu_torch.parallel.multistream import MultiStreamPipeline
from chessboard_vision_tpu_torch.rules import GameState, chess
from chessboard_vision_tpu_torch.session.drift import DriftMonitor
from chessboard_vision_tpu_torch.session.inference import infer_move_from_diff
from chessboard_vision_tpu_torch.utils.checkpoint import load_tree, read_meta, save_tree, tree_map
from chessboard_vision_tpu_torch.utils.config import (
    PIECE_SETTINGS_FILE,
    SENSITIVITY_FILE,
    load_json_config,
)
from chessboard_vision_tpu_torch.utils.logging import get_logger


class _StreamState:
    def __init__(self):
        self.game = GameState()
        self.stable_occupancy = None
        self.stable_count = 0
        self.last_move_time = 0.0
        self.refresh_next = False


class MultiStreamSession:
    STABILITY_REQUIRED = 20
    MOVE_COOLDOWN = 2.0
    FULL_SCAN_PERIOD = 30

    def __init__(
        self,
        geometry,
        n_streams: int,
        on_move_detected: Optional[Callable[[int, "chess.Move"], bool]] = None,
        auto_recalibrate: bool = False,
        drift_check_interval: int = 300,
        drift_threshold_px: float = 4.0,
        drift_max_px: float = 80.0,
        drift_confirm: int = 2,
        device="cuda",
        **pipeline_kw,
    ):
        """``geometry``: one BoardGeometry for all rigs or a list of N.
        ``pipeline_kw`` go to MultiStreamPipeline; the tuned settings files
        are read as GameSession.configure reads them, explicit keywords
        win. ``auto_recalibrate`` turns on the per-rig drift checks, with
        the ``drift_*`` gates of session/drift.py."""
        self.n = n_streams
        if isinstance(geometry, (list, tuple)):
            self.geometries = list(geometry)
        else:
            self.geometries = [geometry] * n_streams
        pipeline_kw.setdefault("piece_settings", load_json_config(PIECE_SETTINGS_FILE))
        pipeline_kw.setdefault("change_settings", load_json_config(SENSITIVITY_FILE))
        self._pipeline_kw = dict(pipeline_kw, device=device)
        self.ms = MultiStreamPipeline(geometry, n_streams=n_streams, **self._pipeline_kw)
        self.device = self.ms.device
        self.state = self.ms.init_state()
        self.streams = [_StreamState() for _ in range(n_streams)]
        self.frame_count = 0
        self.on_move_detected = on_move_detected or (lambda i, m: True)
        self.log = get_logger("msession")
        self.drift_check_interval = int(drift_check_interval)
        self.drift: Optional[List[DriftMonitor]] = None
        if auto_recalibrate:
            self.drift = [
                DriftMonitor(g.src_corners, threshold_px=drift_threshold_px, max_px=drift_max_px,
                             confirm=drift_confirm, device=self.device)
                for g in self.geometries
            ]

    def capture_reference(self, frames):
        """Every stream's visual reference from frames (N, H, W, 3) HWC or
        (N, 3, H, W) planar u8; with drift checks on, each rig's frame
        seeds its detector's baseline."""
        self.state = self.ms.capture_reference(self.state, frames)
        if self.drift is not None:
            for mon, frame in zip(self.drift, self._hwc_frames(frames)):
                mon.check(frame)

    @staticmethod
    def _hwc_frames(frames) -> np.ndarray:
        """(N, H, W, 3) host frames for the corner detector, from the HWC
        or the planar (N, 3, H, W) layout."""
        arr = np.asarray(frames)
        if arr.ndim == 4 and arr.shape[1] == 3 and arr.shape[-1] != 3:
            arr = np.moveaxis(arr, 1, -1)
        return arr

    def _check_drift(self, frames):
        """One drift check a rig; the rigs confirmed bumped get their new
        corners in ONE rebuild (a shared mount shifts them all at once) in
        per-stream-geometry mode. Only those rigs' device state is replaced
        (their frame passed the drift gates); the others keep theirs, since
        re-capturing them from unvetted frames could bake a hand or a move
        in progress into their background model."""
        hwc = self._hwc_frames(frames)
        confirmed = []
        for i, mon in enumerate(self.drift):
            new_corners = mon.check(hwc[i])
            if new_corners is not None:
                confirmed.append(i)
                # np.rint: reorder() truncates float input
                self.geometries[i] = self.geometries[i].with_corners(np.rint(new_corners))
        if not confirmed:
            return
        self.log.warning("streams %s auto-recalibrating to shifted corners", confirmed)
        self.ms = MultiStreamPipeline(self.geometries, n_streams=self.n, **self._pipeline_kw)
        fresh = self.ms.capture_reference(self.ms.init_state(), frames)
        idx = torch.as_tensor(confirmed, device=self.device)
        self.state = tree_map(lambda old, new: old.index_copy(0, idx, new[idx]),
                              self.state, fresh)
        for i in confirmed:
            st = self.streams[i]
            st.stable_count = 0
            st.stable_occupancy = None
            st.refresh_next = False

    def _smart_scan_mask(self, st: _StreamState) -> np.ndarray:
        squares = set(st.game.get_board_occupancy())
        for move in st.game.board.legal_moves:
            squares.add((chess.square_file(move.to_square), chess.square_rank(move.to_square)))
        return positions_to_mask(squares)

    def on_frames(self, frames) -> List[Optional["chess.Move"]]:
        """One tick: N frames -> the committed move (or None) per stream.
        One upload and one readback (occupancy and the FSM's blocked flag)."""
        self.frame_count += 1
        if self.frame_count % self.FULL_SCAN_PERIOD != 0:
            s2c = np.stack([self._smart_scan_mask(st) for st in self.streams])
        else:
            s2c = None
        refresh = np.array([st.refresh_next for st in self.streams])
        for st in self.streams:
            st.refresh_next = False

        if self.drift is not None and self.frame_count % self.drift_check_interval == 0:
            self._check_drift(frames)

        self.state, out = self.ms.step(self.state, frames, s2c_masks=s2c, refresh=refresh)
        host = torch.cat([out.step.occupancy, out.noise.blocked[:, None]], dim=1).cpu().numpy()
        moves: List[Optional[chess.Move]] = []
        now = time.time()
        for i, st in enumerate(self.streams):
            vision = occupancy_to_set(host[i, :64])
            moves.append(self._process_stable_move(i, st, vision, bool(host[i, 64]), now))
        return moves

    def _process_stable_move(self, idx, st: _StreamState, vision, blocked, now):
        expected = st.game.get_board_occupancy()
        missing = expected - vision
        extra = vision - expected
        if len(missing) + len(extra) > 4:
            st.stable_count = 0
            st.stable_occupancy = set()
        elif st.stable_occupancy == vision:
            st.stable_count += 1
        else:
            st.stable_occupancy = set(vision)
            st.stable_count = 1

        if (
            st.stable_count >= self.STABILITY_REQUIRED
            and (now - st.last_move_time) > self.MOVE_COOLDOWN
            and not blocked
        ):
            move = self._infer_move(st, missing, extra, vision)
            if move and self.on_move_detected(idx, move):
                if move in st.game.board.legal_moves:
                    st.game.board.push(move)
                    st.last_move_time = now
                    st.refresh_next = True
                    st.stable_count = 0
                    self.log.info("stream %d: committed %s", idx, move.uci())
                    return move
        return None

    def _infer_move(self, st, missing, extra, vision):
        # Shared with GameSession (castling-first, pair-match, capture
        # scan): session/inference.py.
        return infer_move_from_diff(st.game, missing, extra, vision, log=self.log)

    def to_pgn(self, stream: int, headers=None, claim_draws=False) -> str:
        """PGN document for one stream's digitized game (rules/pgn.py)."""
        from chessboard_vision_tpu_torch.rules.chesslib import STARTING_FEN
        from chessboard_vision_tpu_torch.rules.pgn import game_to_pgn

        st = self.streams[stream]
        start = st.game.start_fen
        return game_to_pgn(
            [m.uci() for m in st.game.board.move_stack],
            headers=headers,
            start_fen=None if start == STARTING_FEN else start,
            claim_draws=claim_draws,
        )

    # -- checkpoint / resume ----------------------------------------------

    def save_checkpoint(self, path: str):
        """Snapshot all N games mid-play: the batched device state (visual
        references, EMA models, detection history, device noise FSM; leaves
        with a leading (N,) axis) and every stream's host rule state."""
        meta = {
            "n": self.n,
            "frame_count": self.frame_count,
            "streams": [
                {
                    "fen": st.game.get_fen(),
                    "stable_count": st.stable_count,
                    "stable_occupancy": (
                        sorted(st.stable_occupancy)
                        if st.stable_occupancy is not None
                        else None
                    ),
                    "refresh_next": st.refresh_next,
                }
                for st in self.streams
            ],
            "corners": [
                None if g.src_corners is None else np.asarray(g.src_corners).tolist()
                for g in self.geometries
            ],
        }
        save_tree(path, self.state, meta)
        self.log.info("multi-stream checkpoint saved: %s", path)

    def resume_checkpoint(self, path: str) -> dict:
        """Restore a save_checkpoint snapshot into this (already
        constructed, same stream count) session: the device state and every
        stream's game and stability state. Returns the checkpoint meta."""
        n_ckpt = read_meta(path)["n"]
        if n_ckpt != self.n:
            raise ValueError(f"checkpoint has {n_ckpt} streams; this session has {self.n}")
        state, meta = load_tree(path, self.ms.init_state(), self.device)
        # The references were captured under the SAVED corners: rigs whose
        # corners differ from this session's get them back, and the
        # pipeline is rebuilt in per-stream-geometry mode.
        saved = [
            None if c is None else np.asarray(c, np.float64)
            for c in meta.get("corners", [None] * self.n)
        ]
        changed = [
            i for i, c in enumerate(saved)
            if c is not None
            and self.geometries[i].src_corners is not None
            and not np.allclose(c, self.geometries[i].src_corners)
        ]
        if changed:
            self.log.warning("checkpoint geometry differs on streams %s; rebuilding", changed)
            for i in changed:
                self.geometries[i] = self.geometries[i].with_corners(np.rint(saved[i]))
            self.ms = MultiStreamPipeline(self.geometries, n_streams=self.n, **self._pipeline_kw)
        if self.drift is not None:  # monitors at the restored corners, baselines unset
            self.drift = [
                DriftMonitor(g.src_corners, threshold_px=mon.threshold_px, max_px=mon.max_px,
                             confirm=mon.confirm, device=self.device)
                for g, mon in zip(self.geometries, self.drift)
            ]
        self.state = state
        self.frame_count = meta["frame_count"]
        for st, m in zip(self.streams, meta["streams"]):
            st.game.set_fen(m["fen"])
            st.stable_count = m["stable_count"]
            st.stable_occupancy = (
                set(map(tuple, m["stable_occupancy"]))
                if m["stable_occupancy"] is not None
                else None
            )
            st.refresh_next = m["refresh_next"]
            st.last_move_time = 0.0
        self.log.info("multi-stream checkpoint resumed: %s", path)
        return meta
