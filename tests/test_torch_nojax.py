"""The port runs without jax and cv2, as on a machine that has neither.

A subprocess blocks both imports (``sys.modules[name] = None``), imports
every module of the port and runs one pipeline step on the CPU on a frame
from the numpy-only renderer (tools/synth.py).
"""

import os
import pathlib
import re
import subprocess
import sys

import chessboard_vision_tpu_torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = pathlib.Path(chessboard_vision_tpu_torch.__file__).parent

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["cv2"] = None
import numpy as np
import chessboard_vision_tpu_torch as port

names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 20, names

from chessboard_vision_tpu import geometry as geo
from chessboard_vision_tpu_torch.models.pipeline import (
    VisionPipeline, occupancy_to_set, outputs_to_numpy)
from chessboard_vision_tpu_torch.tools.synth import SynthCamera, bench_corners, initial_occupancy

corners = bench_corners(720, 1280)
g = geo.BoardGeometry.from_calibration(corners, display_size=(1280, 720))
cam = SynthCamera(corners, frame_size=(720, 1280), board_px=620)
rng = np.random.default_rng(0)
occ = initial_occupancy()
pipe = VisionPipeline(g, device="cpu")
state = pipe.capture_reference(pipe.init_state(), cam.render(occ, rng))
state, out = pipe.step(state, cam.render(occ, rng))
out = outputs_to_numpy(out)
assert all(np.isfinite(np.asarray(f, np.float64)).all() for f in out)
truth = {(f, r) for f in range(8) for r in range(8) if occ[f, r]}
assert occupancy_to_set(out.occupancy) == truth, sorted(occupancy_to_set(out.occupancy) ^ truth)
assert not any(m == "jax" or m.startswith(("jax.", "jaxlib", "cv2")) for m in sys.modules
               if sys.modules[m] is not None)
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


def test_port_sources_never_import_jax_or_cv2():
    pattern = re.compile(r"^\s*(import (jax|cv2)\b|from (jax|cv2)\b)", re.M)
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert not offenders
    # The smoke script reaches the JAX package's host modules only through
    # the port's own entry points.
    reference = re.compile(r"^\s*(import|from) chessboard_vision_tpu\b", re.M)
    assert not reference.search((REPO / "chip_smoke.py").read_text())


# The JAX package's modules that import no jax, and the only ones the port uses.
_JAX_FREE_HOST_MODULES = (
    "geometry", "rules", "rules.chesslib", "rules.pgn", "utils.config", "utils.logging",
)


def test_port_imports_only_the_jax_free_host_modules_of_the_reference():
    pattern = re.compile(
        r"^\s*(?:from chessboard_vision_tpu\b((?:\.\w+)*) import (\w+)"
        r"|import chessboard_vision_tpu\b((?:\.\w+)*))",
        re.M,
    )
    used = set()
    for path in PORT.rglob("*.py"):
        for m in pattern.finditer(path.read_text()):
            sub = (m.group(1) or m.group(3) or "").lstrip(".")
            # "from chessboard_vision_tpu import geometry" names the module.
            used.add(sub or m.group(2))
    assert used, "the port should use the reference's geometry and rules"
    assert used <= set(_JAX_FREE_HOST_MODULES), sorted(used - set(_JAX_FREE_HOST_MODULES))
