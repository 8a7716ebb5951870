"""A cell assembled from files found by name: a new configuration, traffic
mix and metric added as files alone, beside the benchmark's own."""

import json
import os
import shutil

import pytest

from benchmark import run
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
