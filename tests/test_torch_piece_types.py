"""Piece types and board verification: the port's copies
(rules/piece_types.py, session/board_verifier.py) and the session's
piece-type surface vs the JAX package, on the CPU.

The host modules get the inputs of tests/test_piece_types.py and
tests/test_board_verifier.py, one parametrised case each, and must return
the same arrays, centroids, characters, FENs and reports. Through vision,
the port's GameSession and the JAX one see the same renders with per-type
piece radii: calibrate the type model on the start position, commit e2e4,
then ``full_fen`` and ``verify_position`` must agree.
"""

import numpy as np
import pytest
import torch

from chessboard_vision_tpu.rules import GameState as JGameState
from chessboard_vision_tpu.rules import chess as jchess
from chessboard_vision_tpu.rules import piece_types as jpt
from chessboard_vision_tpu.session import board_verifier as jbv
from chessboard_vision_tpu.session.game_session import GameSession as JaxSession
from chessboard_vision_tpu_torch.rules import GameState as TGameState
from chessboard_vision_tpu_torch.rules import chess as tchess
from chessboard_vision_tpu_torch.rules import piece_types as tpt
from chessboard_vision_tpu_torch.session import board_verifier as tbv
from chessboard_vision_tpu_torch.session.game_session import GameSession as TorchSession

from fixtures import DEFAULT_CORNERS, board_render_maps, make_board_frame

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

BASE_R = {1: 18, 2: 21, 3: 24, 4: 26, 5: 29, 6: 32}  # PAWN..KING px
BASE_E = {1: 1.2, 2: 1.5, 3: 2.1, 4: 2.6, 5: 3.2, 6: 3.8}


def _features(chess, board, jitter=0.0):
    """(radius, extent, occupancy, colors) (64,) of a rules board."""
    radius, extent = np.zeros(64), np.full(64, -1.0)
    occ, colors = np.zeros(64, bool), np.full(64, -1, np.int8)
    for sq in range(64):
        p = board.piece_at(sq)
        if p is not None:
            radius[sq] = BASE_R[p.piece_type] + (jitter if p.color else -jitter)
            extent[sq] = BASE_E[p.piece_type]
            occ[sq], colors[sq] = True, 1 if p.color else 0
    return radius, extent, occ, colors


def _calibrate_and_classify(pt, chess):
    board = chess.Board()
    radius, _, occ, colors = _features(chess, board, jitter=0.5)
    clf = pt.PieceTypeClassifier()
    cents = clf.calibrate(radius, board)
    return cents, clf.classify(radius, occ, colors).tolist()


def _placeholder(pt, chess):
    clf = pt.PieceTypeClassifier()
    clf.centroids = {(1, 1): 18.0}
    occ = np.zeros(64, bool)
    occ[0] = occ[1] = True
    colors = np.zeros(64, np.int8)
    colors[0] = 1
    radius = np.zeros(64)
    radius[0] = 18
    chars = clf.classify(radius, occ, colors)
    mask = np.zeros((8, 8), bool)
    mask[0, 0] = mask[1, 0] = True
    return chars.tolist(), pt.occupancy_to_full_fen(mask, chars, piece_colors=colors)


def _knights_by_extent(pt, chess):
    board = chess.Board()
    radius, extent, occ, colors = _features(chess, board)
    clf = pt.PieceTypeClassifier()
    clf.calibrate(radius, board, extents=extent)
    rad2 = radius.copy()
    rad2[1] = rad2[6] = 0.0
    return (clf.centroids, clf.extent_centroids,
            clf.classify(rad2, occ, colors, extents=extent).tolist(),
            clf.classify(rad2, occ, colors).tolist())


def _close_radii(pt, chess):
    clf = pt.PieceTypeClassifier()
    clf.centroids = {(1, chess.KNIGHT): 22.0, (1, chess.BISHOP): 23.0}
    clf.extent_centroids = {(1, chess.KNIGHT): 1.70, (1, chess.BISHOP): 2.05}
    occ = np.zeros(64, bool)
    occ[1] = occ[2] = True
    colors = np.full(64, -1, np.int8)
    colors[1] = colors[2] = 1
    radius = np.zeros(64)
    radius[1] = radius[2] = 22.0
    extent = np.full(64, -1.0)
    extent[1], extent[2] = 1.72, 2.03
    return clf.classify(radius, occ, colors, extents=extent).tolist()


def _mask_and_average(pt, chess):
    rng = np.random.default_rng(3)
    radii = rng.integers(0, 30, (8, 64)) * (rng.random((8, 64)) > 0.3)
    method = rng.integers(0, 5, (8, 64))
    masked = pt.mask_radii_by_method(radii, method)
    extents = np.where(rng.random((8, 64)) > 0.2, rng.random((8, 64)) * 4, -1.0)
    return (masked.tolist(), pt.average_radii(masked).tolist(),
            pt.average_extents(extents).tolist(), pt.average_radii(masked[0]).tolist())


def _update(pt, chess):
    """calibrate on the start position, then blend in the samples of the
    position after e2e4 with a per-square bias."""
    board = chess.Board()
    radius, extent, _, _ = _features(chess, board)
    clf = pt.PieceTypeClassifier()
    clf.calibrate(radius, board, extents=extent)
    board.push_uci("e2e4")
    radius, extent, occ, colors = _features(chess, board, jitter=0.75)
    radius[28] += 1.5  # e4 reads large, as an isolated piece does
    clf.update(radius, board, extents=extent * 1.1)
    return (clf.centroids, clf.extent_centroids, clf.square_bias.tolist(),
            clf.classify(radius, occ, colors, extents=extent).tolist())


def _initial_verifier(bv, chess):
    perfect = bv.expected_initial_occupancy()
    bad = perfect - {(f, 0) for f in range(8)}
    phantom = perfect | {(4, 4)}
    return [bv.InitialBoardVerifier().verify(perfect), bv.InitialBoardVerifier().verify(bad),
            bv.InitialBoardVerifier(threshold=0.90).verify(phantom)]


def _incremental_verifier(bv, chess):
    gs = JGameState() if bv is jbv else TGameState()
    v = bv.IncrementalBoardVerifier(gs.board)
    occ = v.expected_occupancy()
    out = [sorted(occ), v.verify_move(occ)]
    occ.discard((4, 1))
    out += [v.verify_move(occ), v.verify_move(occ, tolerance=1)]
    gs.board.push_uci("e2e4")
    return out + [sorted(v.expected_occupancy())]


PIECE_TYPE_CASES = {
    "calibrate_and_classify": _calibrate_and_classify,
    "unresolved_square_placeholder": _placeholder,
    "knights_typed_by_extent": _knights_by_extent,
    "close_radii_split_by_extent": _close_radii,
    "mask_and_average": _mask_and_average,
    "update_blends_centroids_and_bias": _update,
}
VERIFIER_CASES = {
    "initial_verifier": _initial_verifier,
    "incremental_verifier": _incremental_verifier,
}


@pytest.mark.parametrize("case", list(PIECE_TYPE_CASES))
def test_piece_types_equal_jax(case):
    fn = PIECE_TYPE_CASES[case]
    assert fn(tpt, tchess) == fn(jpt, jchess)


@pytest.mark.parametrize("case", list(VERIFIER_CASES))
def test_board_verifier_equals_jax(case):
    fn = VERIFIER_CASES[case]
    assert fn(tbv, tchess) == fn(jbv, jchess)


CONFIG = {
    "corners": DEFAULT_CORNERS.tolist(),
    "player_color": "white",
    "orientation_flipped": False,
    "grid_lines_x": None,
    "grid_lines_y": None,
}
# profile_extent is f32 from ring means: XLA:CPU and torch may round a
# mean's last bit differently (ROADMAP Queue C 2), so its centroids are
# compared within this tolerance; radii are integers, compared exactly.
EXTENT_RTOL = 1e-5


def test_session_full_fen_and_verify_position_equal_jax():
    """tests/test_piece_types.py's session flow on both packages' sessions
    (exact Hough, the CPU's auto): calibrate_piece_types on the start
    position, e2e4 committed on the same frame, then full_fen() and
    verify_position() agree with each other and with the rules board."""
    rng = np.random.default_rng(1234)

    def frame(board):
        occ, colors, radii = board_render_maps(board)
        return make_board_frame(occ, rng, piece_colors=colors, piece_radii=radii)

    start, after = jchess.Board(), jchess.Board()
    after.push_uci("e2e4")
    frames0 = [frame(start) for _ in range(7)]
    frames1 = [frame(after) for _ in range(34)]

    jsess, tsess = JaxSession(headless=True), TorchSession(device="cpu")
    assert jsess.on_calibration_requested(None, config=dict(CONFIG))
    assert tsess.on_calibration_requested(config=dict(CONFIG))
    results = []
    for s in (jsess, tsess):
        s.MOVE_COOLDOWN = 0.0
        s.capture_reference_frame(frames0[0])
        assert s.full_fen() is None and s.verify_position()[0] is None
        for f in frames0[1:]:
            s.on_frame(f)
        cents = s.calibrate_piece_types()
        ext_cents = s.piece_types.extent_centroids
        commit = None
        for i, f in enumerate(frames1):
            move = s.on_frame(f)
            if move:
                commit = (move.uci(), i)
                break
        for f in frames1[commit[1] + 1: commit[1] + 1 + s._radius_window.maxlen + 2]:
            s.on_frame(f)
        results.append((cents, ext_cents, commit, s.full_fen(), s.verify_position()))
    (jc, je, jcommit, jfen, jver), (tc, te, tcommit, tfen, tver) = results
    assert len(tc) == 12 and tc == jc
    assert te.keys() == je.keys()
    np.testing.assert_allclose([te[k] for k in je], [je[k] for k in je], rtol=EXTENT_RTOL)
    assert tcommit == jcommit and tcommit[0] == "e2e4"
    assert tfen == jfen
    assert tver == jver and tver[0] is True and tver[2] == after.fen().split()[0]

