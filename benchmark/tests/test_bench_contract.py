"""The run's last line, its refusal without a card, and the modules it loads."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "chessboard_vision_tpu"}


@pytest.mark.parametrize("which", ["player", "hall"])
def test_result_line(which):
    cell = tiny.player() if which == "player" else tiny.hall()
    r = tiny.run_cpu(cell)
    line = json.dumps(r)
    assert json.loads(line) == r
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"  # the numbers compared come last
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    want = {"frame_p95_ms", "frame_p50_ms", "frames_per_s", "setup_s"}
    assert set(r["metrics"]) == want
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    checks = {"vision_mismatch_pct", "f32_rel_gap", "commit_mismatches"}
    if which == "hall":
        checks.add("fsm_mismatch_pct")
    assert set(r["checks"]) == checks
    assert all(set(v) == {"value", "limit"} for v in r["checks"].values())


def test_same_seed_same_inputs():
    """The same seed gives the same rigs, games and frames; another seed others."""
    from benchmark import schedule

    cell = tiny.hall(boards=2)
    t = schedule.Traffic.from_json(cell.traffic, 3.0)

    def inputs(seed):
        corners = run.rig_corners(cell.config, seed)
        scripts = [schedule.BoardScript(t, seed, b) for b in range(2)]
        return corners, scripts, run.render_bank(cell.config, scripts, corners, t.renders,
                                                 seed, "cpu")

    (c1, s1, b1), (c2, s2, b2), (c3, _, b3) = inputs(tiny.SEED), inputs(tiny.SEED), inputs(7)
    assert all((x == y).all() for x, y in zip(c1, c2))
    assert [m.uci() for s in s1 for m in s.moves] == [m.uci() for s in s2 for m in s.moves]
    assert all((x == y).all() for x, y in zip(b1, b2))
    assert not all(x.shape == y.shape and (x == y).all() for x, y in zip(b1, b3))


def test_no_card_no_result():
    """Without a CUDA card the command prints nothing on stdout and exits 3."""
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "player_720p.live30",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tiny.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == run.NO_CARD_RC and p.stdout == ""


def test_nothing_of_jax_is_loaded():
    """A run of each entry, and its reference, loads no module whose top-level
    name is jax, jaxlib, flax or chessboard_vision_tpu (compared whole)."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.tests import tiny\n"
            "tiny.run_cpu(tiny.player(), seconds=1.5); tiny.run_cpu(tiny.hall(), seconds=1.5)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n") % tiny.ROOT
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "chessboard_vision_tpu_torch" in top
    assert not top & FORBIDDEN


LATE_IMPORT = """\
import os, sys
sys.path.insert(0, {root!r})
from benchmark import run
from benchmark.tests import tiny
cell = tiny.player()._replace(root={tmp!r}, end_to_end=[{{"name": "late", "unit": "-"}}])
run.find_cell = lambda root, workload: cell
sys.exit(run.main(["--workload", cell.name, "--seed", "1", "--seconds", "1.5"], device="cpu"))
"""


@pytest.mark.parametrize("loads_jax", [False, True])
def test_a_module_loaded_after_the_window_withholds_the_result(tmp_path, loads_jax):
    """A whole run whose metric reader imports a module named jax (a stub, so
    nothing of JAX runs) exits 4 with no result; the same run with a reader
    that imports nothing prints its line and exits 0."""
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    bench = tmp_path / "checkout" / "benchmark"
    (bench / "metrics").mkdir(parents=True)
    for kind in ("drivers", "reference"):
        (bench / kind).symlink_to(os.path.join(tiny.ROOT, "benchmark", kind))
    (bench / "metrics" / "late.py").write_text(
        ("import jax\n" if loads_jax else "") + "def read(run):\n    return 1.0\n")
    code = LATE_IMPORT.format(root=tiny.ROOT, tmp=str(tmp_path / "checkout"))
    env = dict(os.environ, PYTHONPATH=str(tmp_path / "stub"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env=env)
    if loads_jax:
        assert p.returncode == run.FORBIDDEN_RC, p.stderr[-2000:]
        assert p.stdout == "" and "jax" in p.stderr.splitlines()[-1]
    else:
        assert p.returncode == 0, p.stderr[-2000:]
        r = json.loads(p.stdout.strip().splitlines()[-1])
        assert r["metrics"] == {"late": {"value": 1.0, "unit": "-"}}


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, importlib, pkgutil; sys.path.insert(0, %r)\n"
            "import benchmark.reference as r\n"
            "for m in pkgutil.iter_modules(r.__path__): importlib.import_module(r.__name__ + '.' + m.name)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n") % tiny.ROOT
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not top & (FORBIDDEN | {"chessboard_vision_tpu_torch"})
