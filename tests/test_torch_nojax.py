"""The port runs without jax, cv2, requests and the JAX package, as on a
machine that has none of them.

A subprocess blocks the four imports (``sys.modules[name] = None``),
imports every module of the port and runs one plain and one enhanced
pipeline step (conv Hough, planar frames), one exact-backend step on an
HWC tensor (the gather warp), one 2-stream tick, ``api.frame_to_fen``, a
recorded game through ``process_video.run_capture`` fed from memory, the
cv2-free corner detector, the frame ring, the host resampler and
``to_planar_native``, the bilateral's "plain" backend, a step without the
change detector and ``PieceDetectorModel``, on the CPU on frames from the
numpy-only renderer (tools/synth.py), with the geometry from the port's
own copy. The port's copies of the JAX package's host modules
(``geometry``, ``rules``) give the same arrays, moves and FEN as the
originals.

The port's sources import neither jax nor the JAX package, and cv2 only
inside functions, at the sites ``CV2_SITES`` lists: a video file's codec
(``tools/process_video.open_video``), the camera and HighGUI of each
tool's ``main``, the calibrator's default gui (``CalibrationModule.run``),
the board renderer's drawing and the session's windows
(``_draw_interface``), and the cv2 oracles of ``reference/`` (their
``__init__`` and ``apply_color_profile_cv``). So the pipeline, the
sessions, ``run_capture``, the live loop and every tool module import
without cv2, as the subprocess shows. ``requests`` is imported only inside
the Lichess client's methods.
"""

import ast
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import chessboard_vision_tpu_torch
from chessboard_vision_tpu import geometry as jgeo
from chessboard_vision_tpu import rules as jrules
from chessboard_vision_tpu_torch import geometry as tgeo
from chessboard_vision_tpu_torch import rules as trules

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = pathlib.Path(chessboard_vision_tpu_torch.__file__).parent

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["cv2"] = None
sys.modules["chessboard_vision_tpu"] = None
sys.modules["requests"] = None
import numpy as np
import torch
import chessboard_vision_tpu_torch as port

names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 25, names
for name in ("ops.fsm", "ops.hough", "ops.warp", "parallel", "parallel.multistream",
             "parallel.session", "utils.checkpoint", "api", "tools.process_video",
             "rules.piece_types", "session.board_verifier", "models.change_detector",
             "utils.profiling", "contours", "session.drift", "net.lichess_client",
             "session.lichess_session", "native", "tools.play_lichess", "session.renderer",
             "tools.calibration_module", "tools.calibrate_piece_detector",
             "tools.calibrate_sensitivity", "tools.calibrate_colors", "tools.enhance_demo",
             "reference", "reference.replay_session", "parallel.mesh", "parallel.distributed",
             "tools.dryrun_multigpu", "tools.ablate_enhanced", "models"):
    assert port.__name__ + "." + name in names, name

from chessboard_vision_tpu_torch import geometry as geo
from chessboard_vision_tpu_torch.models.pipeline import (
    VisionPipeline, occupancy_to_set, outputs_to_numpy)
from chessboard_vision_tpu_torch.ops.layout import to_planar
from chessboard_vision_tpu_torch.tools.synth import SynthCamera, bench_corners, initial_occupancy

corners = bench_corners(720, 1280)
g = geo.BoardGeometry.from_calibration(corners, display_size=(1280, 720))
cam = SynthCamera(corners, frame_size=(720, 1280), board_px=620)
rng = np.random.default_rng(0)
occ = initial_occupancy()
truth = {(f, r) for f in range(8) for r in range(8) if occ[f, r]}
for enhance, backend, layout in ((False, "conv", to_planar), (True, "conv", to_planar),
                                 (False, "auto", torch.as_tensor)):
    pipe = VisionPipeline(g, with_enhancer=enhance, hough_backend=backend, device="cpu")
    state = pipe.capture_reference(pipe.init_state(), layout(cam.render(occ, rng)))
    state, out = pipe.step(state, layout(cam.render(occ, rng)))
    out = outputs_to_numpy(out)
    assert all(np.isfinite(np.asarray(f, np.float64)).all() for f in out)
    got = occupancy_to_set(out.occupancy)
    assert got == truth, (enhance, backend, sorted(got ^ truth))
assert pipe.hough_backend == "exact"
from chessboard_vision_tpu_torch.parallel import MultiStreamPipeline
from chessboard_vision_tpu_torch.parallel.multistream import outputs_to_numpy as multi_to_numpy
ms = MultiStreamPipeline(g, n_streams=2, hough_backend="conv", device="cpu")
state = ms.capture_reference(ms.init_state(), np.stack([cam.render(occ, rng)] * 2))
state, out = ms.step(state, np.stack([cam.render(occ, rng) for _ in range(2)]))
out = multi_to_numpy(out)
for i in range(2):
    assert occupancy_to_set(out.step.occupancy[i]) == truth, i
from chessboard_vision_tpu_torch.parallel import make_mesh
meshed = MultiStreamPipeline(g, n_streams=2, mesh=make_mesh(2, ("data", "space"), (1, 2),
                                                            devices=["cpu"] * 2),
                             hough_backend="conv")
state = meshed.capture_reference(meshed.init_state(), np.stack([cam.render(occ, rng)] * 2))
state, mout = meshed.step(state, np.stack([cam.render(occ, rng) for _ in range(2)]))
mout = multi_to_numpy(mout)
for i in range(2):
    assert occupancy_to_set(mout.step.occupancy[i]) == truth, i
from chessboard_vision_tpu_torch import api
from chessboard_vision_tpu_torch.rules import chess
from chessboard_vision_tpu_torch.tools import process_video
from chessboard_vision_tpu_torch.tools.demo_pipeline import occupancy_of
ref, moved = cam.render(occ, rng), occ.copy()
moved[4, 1], moved[4, 3] = False, True  # e2e4
fen = api.frame_to_fen(cam.render(moved, rng), corners, reference_frame=ref, device="cpu")
assert fen.split()[0] == "PPPPPPPP/PPPPPPPP/8/8/4P3/8/PPPP1PPP/PPPPPPPP", fen
script = chess.Board()
script.push_uci("e2e4")
frames = [cam.render(occ, rng) for _ in range(3)] + [cam.render(moved, rng) for _ in range(22)]
config = {"corners": corners.tolist(), "display_size": [1280, 720]}
moves, final_fen, n = process_video.run_capture(
    process_video.FrameReader(frames), config, skip_frames=1, device="cpu")
assert (moves, final_fen, n) == (["e2e4"], script.fen(), 22), (moves, final_fen, n)
det = geo.find_chessboard_corners(cam.render(occ, rng), device="cpu")
assert det.shape == (4, 1, 2) and np.abs(det.reshape(4, 2) - corners).max() <= 10, det
from chessboard_vision_tpu_torch.native import FrameRing
ring = FrameRing((2, 3), n_slots=2)
assert ring.push(np.arange(6, dtype=np.uint8).reshape(2, 3)) == 1
seq, got = ring.pop()
assert seq == 1 and got.tolist() == [[0, 1, 2], [3, 4, 5]] and ring.pop() == (0, None)
ring.close()
from chessboard_vision_tpu_torch.models import PieceDetectorModel
from chessboard_vision_tpu_torch.models.enhancer import bilateral
from chessboard_vision_tpu_torch.native import HostResampler, to_planar_native
frame = cam.render(occ, rng)
assert np.array_equal(to_planar_native(frame), to_planar(frame))
board = HostResampler(g.warp_X, g.warp_Y, 720, 1280).resample_gray(frame)
assert board.shape == (g.board_size ** 2,)
plain = bilateral(torch.as_tensor(to_planar(frame))[:, :64, :64], "plain")
assert plain.shape == (3, 64, 64)
nochange = VisionPipeline(g, hough_backend="conv", with_change_detector=False, device="cpu")
state = nochange.capture_reference(nochange.init_state(), to_planar(frame))
state, out = nochange.step(state, to_planar(cam.render(occ, rng)))
out = outputs_to_numpy(out)
assert occupancy_to_set(out.occupancy) == truth and not out.change_intensity.any()
squares = nochange.preprocess(torch.as_tensor(to_planar(frame)))[0]
model = PieceDetectorModel(g.squares.heights, g.squares.widths, device="cpu")
model.calibrate_reference(squares)
assert model.get_occupied_squares(squares) == truth
assert not any(m == "jax" or m.startswith(("jax.", "jaxlib", "cv2", "chessboard_vision_tpu.",
                                           "requests"))
               for m in sys.modules if sys.modules[m] is not None)
print("NOJAX_OK", len(names))
"""


def test_port_imports_and_steps_without_jax_or_cv2():
    env = dict(os.environ, OMP_NUM_THREADS="1")  # the suite runs workers in parallel
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX_OK" in proc.stdout


_IMPORT = re.compile(r"^\s*(?:import|from)\s+([\w.]+)", re.M)


def _imported(path):
    return {m.group(1).split(".")[0] for m in _IMPORT.finditer(path.read_text())}


def _import_sites(path, names):
    """(module, enclosing function or None, column) of each import of a
    top-level module in ``names`` in the file, by its syntax tree."""
    sites = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            mods = []
            if isinstance(child, ast.Import):
                mods = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.module and not child.level:
                mods = [child.module]
            sites.extend((m.split(".")[0], func, child.col_offset) for m in mods
                         if m.split(".")[0] in names)
            visit(child, func)

    visit(ast.parse(path.read_text()), None)
    return sites


# (file under the port, the function whose body imports cv2, its column):
# every cv2 import of the port, none at module level.
CV2_SITES = [
    ("reference/change_detector.py", "__init__", 8),
    ("reference/enhancer.py", "__init__", 8),
    ("reference/enhancer.py", "apply_color_profile_cv", 4),
    ("reference/piece_detector.py", "__init__", 8),
    ("reference/replay_session.py", "__init__", 8),
    ("session/game_session.py", "_draw_interface", 8),
    ("session/renderer.py", "draw_board_overlay", 4),
    ("session/renderer.py", "draw_chess_grid_dynamic", 4),
    ("tools/calibrate_colors.py", "main", 4),
    ("tools/calibrate_piece_detector.py", "main", 4),
    ("tools/calibrate_sensitivity.py", "main", 4),
    ("tools/calibration_module.py", "main", 4),
    ("tools/calibration_module.py", "run", 12),
    ("tools/enhance_demo.py", "main", 4),
    ("tools/play_lichess.py", "main", 4),
    ("tools/process_video.py", "open_video", 4),
]


def test_port_sources_never_import_jax_or_cv2():
    """No jax anywhere; cv2 exactly at CV2_SITES, each inside the body of a
    function, never at module level (chip_smoke.py has none). requests
    only inside functions of net/lichess_client.py."""
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    allowed = {(PORT / path, func) for path, func, _ in CV2_SITES}
    client = PORT / "net" / "lichess_client.py"
    sites = {p: _import_sites(p, {"jax", "jaxlib", "cv2", "requests"}) for p in files}
    offenders = [(str(p), s) for p, ss in sites.items() for s in ss
                 if not (s[0] == "cv2" and (p, s[1]) in allowed)
                 and not (s[0] == "requests" and p == client and s[1] is not None)]
    assert not offenders
    cv2_sites = sorted((p.relative_to(PORT).as_posix(), s[1], s[2])
                       for p, ss in sites.items() for s in ss if s[0] == "cv2")
    assert cv2_sites == CV2_SITES, cv2_sites
    assert len(sites[client]) >= 5  # the client's HTTP methods, each importing it


def test_port_imports_only_the_jax_free_host_modules_of_the_reference():
    """No file of the port, and not chip_smoke.py, imports the JAX package:
    the port keeps its own copies of the host modules it needs."""
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p) for p in files if "chessboard_vision_tpu" in _imported(p)]
    assert not offenders
    assert "chessboard_vision_tpu_torch" in _imported(PORT / "models" / "pipeline.py")


@pytest.mark.parametrize("grid", [False, True], ids=["linear_grid", "smart_grid"])
def test_copied_geometry_equals_the_reference(grid):
    """The port's geometry copy builds the same BoardGeometry arrays."""
    corners = np.array([[260, 80], [1020, 95], [240, 640], [1035, 655]])
    kw = dict(display_size=(1280, 720), orientation_flipped=grid)
    if grid:
        kw.update(grid_lines_x=[0, 80, 155, 232, 310, 388, 466, 544, 620],
                  grid_lines_y=[0, 76, 154, 233, 311, 389, 466, 543, 620], blur_pad=3)
    j = jgeo.BoardGeometry.from_calibration(corners, **kw)
    t = tgeo.BoardGeometry.from_calibration(corners, **kw)
    for name in ("matrix", "warp_X", "warp_Y", "src_corners"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    assert (t.board_size, t.grid_x, t.grid_y) == (j.board_size, j.grid_x, j.grid_y)
    for name in ("ix", "iy", "mask", "heights", "widths", "counts"):
        np.testing.assert_array_equal(getattr(t.squares, name), getattr(j.squares, name),
                                      err_msg=name)
    for a, b in zip(t.square_query_coords() + t.board_tile_query_coords()[:2],
                    j.square_query_coords() + j.board_tile_query_coords()[:2]):
        np.testing.assert_array_equal(a, b)


def test_copied_rules_give_the_same_moves_and_fen():
    """A game with castling, en passant and a promotion through both rules
    copies: the same legal moves after each ply, FEN, PGN and occupancy FEN."""
    plies = "e2e4 d7d5 e4d5 c7c5 d5c6 g8f6 c6b7 e7e6 b7a8q f8e7 g1f3 e8g8 f1c4".split()
    jb, tb = jrules.chess.Board(), trules.chess.Board()
    for uci in plies:
        assert sorted(m.uci() for m in tb.legal_moves) == sorted(m.uci() for m in jb.legal_moves)
        jb.push_uci(uci)
        tb.push_uci(uci)
        assert tb.fen() == jb.fen()
    assert trules.game_to_pgn(plies) == jrules.game_to_pgn(plies)
    jg, tg = jrules.GameState(), trules.GameState()
    occ = jg.get_board_occupancy()
    occ.discard((4, 1))
    occ.add((4, 3))
    assert [str(x) for x in tg.process_occupancy_change(set(occ))] == [
        str(x) for x in jg.process_occupancy_change(set(occ))]
    assert tg.get_fen() == jg.get_fen()
    grid = np.zeros((8, 8), bool)
    for f, r in occ:
        grid[f, r] = True
    assert trules.occupancy_to_fen(grid) == jrules.occupancy_to_fen(grid)
