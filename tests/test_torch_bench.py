"""The port's bench (chessboard_vision_tpu_torch/tools/bench.py) and the
frame intake it needs, on the CPU.

- ``MultiStreamPipeline`` takes frames as a tensor (``capture_reference``,
  ``step``, ``step_chunk``, unmeshed and on a mesh of two CPU slots) with
  the outputs of the same frames as a host array, and those equal the JAX
  package's ``step_chunk`` (bool/i32 exactly, f32 within
  tests/test_torch_multistream.py's tolerance).
- The bench's chunked loop (``measure_chunked``) turns every frame into the
  FEN that the JAX ``VisionPipeline.step_many`` gives on the same frames.
- The bench's frame is bench.py's, bit for bit: ``tools.synth.draw_circle``
  rasterizes as ``cv2.circle`` does.
- ``--dry`` runs to its JSON line without jax or cv2; without a card it
  exits with rc 3; ``STAGE_OF`` is bench.py's stage map on the port's files.
"""

import ast
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chessboard_vision_tpu import geometry as jgeo
from chessboard_vision_tpu.models.pipeline import VisionPipeline as JaxPipeline
from chessboard_vision_tpu.parallel.multistream import MultiStreamPipeline as JaxMulti
from chessboard_vision_tpu.rules import occupancy_to_fen as jax_occupancy_to_fen
from chessboard_vision_tpu_torch import geometry as tgeo
from chessboard_vision_tpu_torch.models.pipeline import VisionPipeline as TorchPipeline
from chessboard_vision_tpu_torch.ops.layout import to_planar
from chessboard_vision_tpu_torch.parallel import make_mesh
from chessboard_vision_tpu_torch.parallel import multistream as tms
from chessboard_vision_tpu_torch.tools import bench
from chessboard_vision_tpu_torch.tools.synth import bench_corners, draw_circle

from test_torch_multistream import assert_multi_match

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "chessboard_vision_tpu_torch"
H, W = 360, 640  # the bench's --dry frame


def _jax_bench():
    """The repo root's bench.py (it imports jax and cv2 only inside its
    functions)."""
    spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scene():
    """The --dry frame, its planar form, and both packages' geometry of the
    benchmark's board layout."""
    frame, _ = bench.synth_frame(np.random.default_rng(0), H, W)
    corners = bench_corners(H, W)
    return (frame, to_planar(frame), jgeo.BoardGeometry.from_calibration(corners, (W, H)),
            tgeo.BoardGeometry.from_calibration(corners, (W, H)))


def _noisy_planar(frame, seed, n):
    r = np.random.default_rng(seed)
    return np.stack([to_planar(bench.noisy(frame, r)) for _ in range(n)])


def _assert_same(a, b, where):
    """Two port MultiStreamOutputs (or states) with equal leaves, bit for bit."""
    a, b = tms.outputs_to_numpy(a), tms.outputs_to_numpy(b)
    for part in ("step", "noise"):
        for f in getattr(a, part)._fields:
            x, y = getattr(getattr(a, part), f), getattr(getattr(b, part), f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f"{where} {part}.{f}"


def _assert_same_state(a, b, where):
    a, b = tms.multistream_state_to_numpy(a), tms.multistream_state_to_numpy(b)
    for part_a, part_b in ((a.pipe.piece, b.pipe.piece), (a.pipe.change, b.pipe.change),
                           (a.noise, b.noise)):
        for f in part_a._fields:
            x, y = getattr(part_a, f), getattr(part_b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f"{where} {f}"


def test_multistream_takes_tensor_frames_as_host_frames_and_jax(scene):
    """n = 2 streams, T = 2 ticks at 360x640: capture_reference, step_chunk
    and step on a CPU tensor equal the same calls on the numpy array, and
    step_chunk equals the JAX package's; a mesh of two CPU slots takes the
    tensor too, with the unmeshed pipeline's outputs."""
    frame, planar, jg, tg = scene
    ref = np.stack([planar] * 2)
    chunk = np.stack([_noisy_planar(frame, 1, 2), _noisy_planar(frame, 2, 2)])  # (T, n, 3, H, W)
    jm = JaxMulti(jg, n_streams=2, hough_backend="conv")
    js = jm.capture_reference(jm.init_state(), jnp.asarray(ref))
    js, jo = jm.step_chunk(js, jnp.asarray(chunk))

    tm = tms.MultiStreamPipeline(tg, 2, hough_backend="conv", device="cpu")
    host = tm.capture_reference(tm.init_state(), ref)
    dev = tm.capture_reference(tm.init_state(), torch.as_tensor(ref))
    _assert_same_state(dev, host, "capture_reference")
    host, host_out = tm.step_chunk(host, chunk)
    dev, dev_out = tm.step_chunk(dev, torch.as_tensor(chunk))
    assert dev_out.step.occupancy.shape == (2, 2, 64)
    _assert_same(dev_out, host_out, "step_chunk")
    _assert_same_state(dev, host, "step_chunk")
    assert_multi_match(dev_out, jo, where="step_chunk vs JAX")
    masks = np.zeros((2, 64), bool)
    masks[1, 12] = True
    host, host_out = tm.step(host, chunk[0], s2c_masks=masks, refresh=[True, False])
    dev, dev_out = tm.step(dev, torch.as_tensor(chunk[0]), s2c_masks=masks, refresh=[True, False])
    _assert_same(dev_out, host_out, "step")
    _assert_same_state(dev, host, "step")

    mesh = make_mesh(2, devices=["cpu"] * 2)
    meshed = tms.MultiStreamPipeline(tg, 2, mesh=mesh, hough_backend="conv")
    ms = meshed.capture_reference(meshed.init_state(), torch.as_tensor(ref))
    ms, mesh_out = meshed.step_chunk(ms, torch.as_tensor(chunk))
    _, plain_out = tm.step_chunk(tm.capture_reference(tm.init_state(), ref), chunk)
    _assert_same(mesh_out, plain_out, "meshed step_chunk")


def test_measure_chunked_fens_equal_jax_step_many(scene):
    """measure_chunked at K = 4 over the distinct chunks of seeds 1 and 2
    and a third chunk in which e2's disc is covered by an empty square:
    every frame's FEN, in order, equals occupancy_to_fen of the JAX
    step_many (inner_chunk=0) on the same frames from the same state."""
    frame, planar, jg, tg = scene
    k = 4
    covered = frame.copy()
    bs = min(H, W) - 100
    sq, x0, y0 = bs // 8, (W - bs) // 2, (H - bs) // 2
    row = (7 - 1) * sq  # rank 2
    covered[y0 + row:y0 + row + sq, x0 + 4 * sq:x0 + 5 * sq] = \
        covered[y0 + 3 * sq:y0 + 4 * sq, x0 + 3 * sq:x0 + 4 * sq]  # an empty square of e2's shade
    chunks = [_noisy_planar(frame, 1, k), _noisy_planar(frame, 2, k),
              _noisy_planar(covered, 3, k)]
    n_chunks = 4  # the untimed chunk, then chunks 0, 1, 2, 0

    tp = TorchPipeline(tg, hough_backend="conv", device="cpu")
    state = tp.capture_reference(tp.init_state(), torch.as_tensor(planar))
    extras = {}
    _, best, fens = bench.measure_chunked(tp, state, [torch.as_tensor(c) for c in chunks],
                                          n_chunks, 1, "distinct", extras)
    assert best > 0 and extras["pass_median_fps"]["distinct"] > 0

    jp = JaxPipeline(jg, hough_backend="conv")
    js = jp.capture_reference(jp.init_state(), jnp.asarray(planar))
    js, _ = jp.step_many(js, jnp.asarray(chunks[0]), inner_chunk=0)
    want = []
    for i in range(n_chunks):
        js, out = jp.step_many(js, jnp.asarray(chunks[i % len(chunks)]), inner_chunk=0)
        want += [jax_occupancy_to_fen(occ.reshape(8, 8).T) for occ in np.asarray(out.occupancy)]
    assert fens == want
    boards = [f.split()[0] for f in fens]
    truth = bench.occupancy_to_fen(bench.OCCUPANCY).split()[0]
    assert boards[:2 * k] == [truth] * (2 * k)
    assert "PPPPPPPP/PPPPPPPP/8/8/8/8/PPPP1PPP/PPPPPPPP" in boards[2 * k:3 * k], boards


@pytest.mark.parametrize("h,w", [(360, 640), (1080, 1920)])
def test_synth_frame_is_bench_py_frame_bit_for_bit(h, w):
    """The port's numpy synth_frame equals bench.py's cv2 one, bit-equal
    (not within a share of differing pixels), from the same seed."""
    want, want_board = _jax_bench().synth_frame(np.random.default_rng(7), h, w)
    got, got_board = bench.synth_frame(np.random.default_rng(7), h, w)
    assert got_board == want_board
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("thickness", [-1, 2, 3])
def test_draw_circle_equals_cv2_circle(thickness):
    """draw_circle equals cv2.circle (default line type) at every radius
    0-60 and several centers, filled and outlined."""
    import cv2

    rng = np.random.default_rng(thickness + 10)
    for radius in range(61):
        center = (int(rng.integers(70, 90)), int(rng.integers(70, 90)))
        want = np.zeros((160, 170, 3), np.uint8)
        got = want.copy()
        cv2.circle(want, center, radius, (200, 1, 90), thickness)
        draw_circle(got, center, radius, (200, 1, 90), thickness)
        assert np.array_equal(got, want), (radius, center)
    with pytest.raises(ValueError):
        draw_circle(got, (3, 80), 10, (1, 2, 3), thickness)


def test_bench_dry_prints_its_line_without_jax_or_cv2():
    """``python -m chessboard_vision_tpu_torch.tools.bench --dry`` (with one
    pass and 2 streams, so the rigs stay short on the CPU) exits 0 and
    prints one JSON line with bench.py's keys and the port's, with jax,
    cv2 and the JAX package blocked and never imported."""
    script = (
        "import runpy, sys\n"
        "for m in ('jax', 'cv2', 'chessboard_vision_tpu'):\n"
        "    sys.modules[m] = None\n"
        "sys.argv = ['bench', '--dry', '--passes', '1', '--streams', '2']\n"
        "runpy.run_module('chessboard_vision_tpu_torch.tools.bench', run_name='__main__')\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'cv2', 'chessboard_vision_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "extras"}
    assert line["metric"] == "fps_1080p_frame_to_fen" and line["unit"] == "fps"
    assert line["value"] > 0
    extras = line["extras"]
    fps = ("distinct_frames_fps", "host_frames_fps", "batched_aggregate_fps",
           "batched_host_frames_fps", "batched_distinct_fps", "batched_4stream_fps")
    for key in fps:
        assert extras[key] > 0, key
    assert set(extras["pass_median_fps"]) == {"same-frame", "distinct", "host-frames"}
    assert extras["chunk"] == 4 and extras["frames"] == 16 and extras["batched_streams"] == 2
    assert extras["strict_sync_p50_ms"] > 0
    assert extras["device"] == {"name": "cpu", "nvidia_smi": None, "count": 0}
    assert len(extras["peak_mem_gb"]) == 4
    assert "per_stage_ms" not in extras  # a CPU trace has no device lane


def test_bench_without_a_card_exits_3(monkeypatch, capsys):
    """Without --dry and without a CUDA card the bench says why and exits
    with rc 3: there is no CPU fallback and nothing is measured."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main(["--frames", "16"])
    assert e.value.code == 3
    out = capsys.readouterr()
    assert out.out == "" and "torch.cuda.is_available() is False" in out.err


def test_stage_map_is_bench_py_map_on_the_port_files():
    """Every key of STAGE_OF is a file of the port, and every key of
    bench.py's _STAGE_OF (read from its source) with a port file at the
    same path maps to the same stage."""
    tree = ast.parse((REPO / "bench.py").read_text())
    jax_map = next(ast.literal_eval(node.value) for node in tree.body
                   if isinstance(node, ast.Assign)
                   and any(getattr(t, "id", None) == "_STAGE_OF" for t in node.targets))
    for key in bench.STAGE_OF:
        assert (PORT / key).is_file(), key
    shared = [k for k in jax_map if (PORT / k).is_file()]
    assert len(shared) >= 12, shared
    for key in shared:
        assert bench.STAGE_OF[key] == jax_map[key], key


def test_window_counts_reads_the_windows_own_launches_and_records():
    """window_counts of a padded window's trace: the launch calls after the
    PAD_LAUNCHES pads (by time, whatever their order in the file), and how
    many of those have a device record by correlation; the pads' records
    and a record without a launch count for nothing."""
    from chessboard_vision_tpu_torch.utils.profiling import PAD_LAUNCHES

    def call(corr, ts, name="cudaLaunchKernel"):
        return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1,
                "args": {"correlation": corr}}

    def record(corr):
        return {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 1,
                "args": {"correlation": corr}}

    pads = [call(i, i) for i in range(PAD_LAUNCHES)]
    own = [call(100, 50), call(101, 51, "cudaMemcpyAsync"), call(102, 52)]
    other = [call(200, 53, "cudaStreamSynchronize")]  # not a launch
    events = (own[::-1] + pads + other + [record(i) for i in range(3, PAD_LAUNCHES)]
              + [record(100), record(102), record(999)])
    assert bench.window_counts(events) == {"launches": 3, "records": 2}
