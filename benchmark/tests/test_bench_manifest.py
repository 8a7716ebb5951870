"""A cell assembled from files found by name: a new configuration, traffic
mix, metric, reference and session rules added as files alone, beside the
benchmark's own; a configuration that its reference does not implement
refused before set-up."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import compare, run
from benchmark.tests.tiny import MIX, ROOT, SEED, SIZES


@pytest.fixture
def checkout(tmp_path):
    """A copy of BENCHMARK.json and benchmark/, with a configuration, a mix
    and an end-to-end metric of its own added as new files."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    with open(os.path.join(ROOT, "benchmark", "configs", "hall_1080p.json")) as fh:
        cfg = dict(json.load(fh), name="hall_tiny", boards=3, **SIZES)
    (tmp_path / "benchmark" / "configs" / "hall_tiny.json").write_text(json.dumps(cfg))
    with open(os.path.join(ROOT, "benchmark", "traffic", "capacity.json")) as fh:
        mix = dict(json.load(fh), **MIX, stagger=10, max_moves=2)
    (tmp_path / "benchmark" / "traffic" / "burst.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark" / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n    return len(run.call_s) / run.window_s\n")
    manifest["configs"].append({"name": "hall_tiny", "source": "https://example.org/hall",
                                "file": "benchmark/configs/hall_tiny.json", "reduced": [],
                                "why": "a test"})
    manifest["workloads"].append({"name": "hall_tiny.burst", "config": "hall_tiny",
                                  "traffic": "burst", "chips": 1, "why": "a test"})
    manifest["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                                   "bound": 0.1, "source": "host_clock",
                                   "workloads": ["hall_tiny.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return str(tmp_path)


def test_cell_found_by_name(checkout):
    cell = run.find_cell(checkout, "hall_tiny.burst")
    assert cell.root == checkout and cell.config["boards"] == 3
    assert cell.traffic["max_moves"] == 2
    assert [m["name"] for m in cell.end_to_end] == ["frame_p95_ms", "setup_s", "calls_per_s"]
    assert cell.per_layer == []
    own = run.find_cell(checkout, "player_720p.live30")
    assert [m["name"] for m in own.end_to_end] == ["frame_p95_ms", "frame_p50_ms", "setup_s"]
    assert len(own.per_layer) == 5


def test_a_run_of_the_added_cell(checkout):
    import time

    cell = run.find_cell(checkout, "hall_tiny.burst")
    r, _ = run.run_cell(cell, SEED, 3.0, False, device="cpu", t_start=time.perf_counter())
    assert r["correct"] is True
    assert set(r["metrics"]) == {"frame_p95_ms", "setup_s", "calls_per_s"}
    assert r["metrics"]["calls_per_s"]["value"] > 0


def test_every_metric_of_the_manifest_has_its_reader():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert callable(run.metric_reader(m["name"]))
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert os.path.exists(os.path.join(ROOT, "benchmark", "drivers", cfg["session"] + ".py"))
    for w in manifest["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json"))


def add_cell(checkout: str, name: str, files: dict = None, **config) -> str:
    """Add cell ``<name>.burst`` to the checkout, and return its name: hall_tiny
    with ``config``'s keys set, and ``files`` ({path under benchmark/: text})
    added beside it."""
    bench = os.path.join(checkout, "benchmark")
    for path, text in (files or {}).items():
        with open(os.path.join(bench, path), "w") as fh:
            fh.write(text)
    with open(os.path.join(bench, "configs", "hall_tiny.json")) as fh:
        cfg = dict(json.load(fh), name=name, **config)
    with open(os.path.join(bench, "configs", name + ".json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(checkout, "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    manifest["configs"].append({"name": name, "source": "https://example.org/hall",
                                "file": f"benchmark/configs/{name}.json", "reduced": [],
                                "why": "a test"})
    manifest["workloads"].append({"name": name + ".burst", "config": name, "traffic": "burst",
                                  "chips": 1, "why": "a test"})
    with open(os.path.join(checkout, "BENCHMARK.json"), "w") as fh:
        json.dump(manifest, fh)
    return name + ".burst"


def run_tiny(checkout: str, workload: str):
    cell = run.find_cell(checkout, workload)
    return run.run_cell(cell, SEED, 3.0, False, device="cpu", t_start=time.perf_counter())


WRAPPED = '''"""The frozen pipeline behind a wrapper of its own{what}."""

from . import pipeline

IMPLEMENTS = pipeline.IMPLEMENTS


class Wrapped:
    def __init__(self, pipe):
        self.pipe, self.n, self.device = pipe, pipe.n, pipe.device

    def init_state(self):
        return self.pipe.init_state()

    def capture(self, state, frames):
        return self.pipe.capture(state, frames)

    def step(self, state, frames, s2c, given, refresh):
        state, out = self.pipe.step(state, frames, s2c, given, refresh)
        if {flip}:
            occupancy = out.occupancy.clone()
            occupancy[0] = ~occupancy[0]
            out = out._replace(occupancy=occupancy)
        return state, out


def build(config, geometries, device, resample_dtype):
    return Wrapped(pipeline.build(config, geometries, device, resample_dtype))
'''


@pytest.mark.parametrize("flip", [False, True])
def test_a_reference_added_as_a_file_alone(checkout, flip):
    """A configuration's ``reference`` names a module added beside the frozen
    ones; that module is the one compared: with one square's occupancy
    flipped in its step, the run is not correct."""
    what = ", square a1 of the first board flipped every step" if flip else ""
    workload = add_cell(checkout, "hall_wrapped", reference="wrapped",
                        files={"reference/wrapped.py": WRAPPED.format(what=what, flip=flip)})
    r, record = run_tiny(checkout, workload)
    assert record.config["reference"] == "wrapped"
    assert r["correct"] is not flip
    assert (r["checks"]["vision_mismatch_pct"]["value"] > 0) is flip


@pytest.mark.parametrize("setting, line", [
    ({"use_enhancer": True}, "use_enhancer true: reference pipeline does not implement it"),
    ({"hough_backend": "exact"}, 'hough_backend "exact": reference pipeline does not implement it'),
])
def test_an_unimplemented_setting_is_refused_before_set_up(checkout, setting, line):
    """A configuration with no reference of its own, whose ``pipeline`` the
    frozen reference does not implement: the cell is refused as it is read,
    and a whole run from the checkout exits non-zero with no result, before
    it looks for a card or renders a frame."""
    with open(os.path.join(checkout, "benchmark", "configs", "hall_tiny.json")) as fh:
        pipeline = dict(json.load(fh)["pipeline"], **setting)
    workload = add_cell(checkout, "hall_other", pipeline=pipeline)
    with pytest.raises(SystemExit, match=line):
        run.find_cell(checkout, workload)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
                        str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=checkout, capture_output=True, text=True, timeout=300)
    assert p.returncode not in (0, run.NO_CARD_RC), p.stderr[-2000:]
    assert p.stdout == "" and line in p.stderr.splitlines()[-1]


HALL_RULES = '''"""The hall's rules with the first board's noise flag reported flipped."""

from .sessions import ReferenceHall


class FlippedHall(ReferenceHall):
    def call(self, frames, now):
        out, blocked = super().call(frames, now)
        blocked = blocked.copy()
        blocked[0] = ~blocked[0]
        return out, blocked
'''


@pytest.mark.parametrize("rules", ["sessions.ReferenceHall", "hall_rules.FlippedHall"])
def test_a_driver_names_the_module_of_its_rules(checkout, rules):
    """A driver's ``REFERENCE`` as "<module>.<Class>" of benchmark/reference/:
    the frozen hall's rules spelled out compare as the bare name does, and
    rules added as a file alone are the ones compared."""
    with open(os.path.join(ROOT, "benchmark", "drivers", "multistream_session.py")) as fh:
        driver = fh.read()
    assert 'REFERENCE = "ReferenceHall"' in driver
    workload = add_cell(checkout, "hall_named", session="hall_named", files={
        "drivers/hall_named.py": driver.replace('"ReferenceHall"', repr(rules)),
        "reference/hall_rules.py": HALL_RULES,
    })
    r, _ = run_tiny(checkout, workload)
    assert r["correct"] is (rules == "sessions.ReferenceHall")
    assert (r["checks"]["fsm_mismatch_pct"]["value"] > 0) is (rules != "sessions.ReferenceHall")


def test_the_frozen_reference_resolves_to_the_imported_modules():
    """In the benchmark's own checkout a name resolves to the module that the
    import system holds, so its classes are those the tests import."""
    from benchmark.reference import pipeline, sessions

    assert compare.load_reference(ROOT, "sessions").ReferenceHall is sessions.ReferenceHall
    assert compare.load_reference(ROOT, compare.PIPELINE) is pipeline
    for name in ("player_720p", "hall_1080p"):
        with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as fh:
            assert compare.unimplemented(json.load(fh), ROOT) == []
