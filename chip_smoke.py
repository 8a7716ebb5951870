#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing a line of its own; any failure raises and exits non-zero before
the last line:

1. device: a CUDA card of compute capability 9.0, its name, and its name
   and power limit as nvidia-smi gives them.
2. build: the score-matmul kernel (chessboard_vision_tpu_torch/kernels/
   score_matmul.cu) compiled with nvcc for sm_90a, and the seconds it took.
3. kernel vs plain at the 1080p shapes: the real (7168, 3200) Hough basis
   with the pooled planes of a rendered 1920x1080 frame, and random bf16
   operands of the same shapes. Scores within rtol 2e-4 / atol 2e-3, the
   per-square masked first-max argmax equal; both timed with CUDA events.
4. pipeline: VisionPipeline(device="cuda") on rendered 1920x1080 frames of
   the benchmark's board layout: a clean frame's occupancy equals the
   rendered truth; step_many over 64 frames equals 64 sequential steps
   (bool/i32 exactly, f32 within the CPU tests' tolerance); ms per frame.
5. session: the port's GameSession plays e2e4 e7e5 through on_frame and
   must commit exactly those moves and reach the script's FEN.

Kernel launch counts are zeroed just before phase 4 and read after phase 5,
so they show that the main path itself went through the kernel. The line
before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import time

import numpy as np
import torch

from chessboard_vision_tpu_torch.kernels import build
from chessboard_vision_tpu_torch.kernels import score_matmul as sm
from chessboard_vision_tpu_torch.models import pipeline as tp
from chessboard_vision_tpu_torch.ops.hough_conv import edge_planes
from chessboard_vision_tpu_torch.ops.layout import to_planar
from chessboard_vision_tpu_torch.tools.demo_pipeline import calibrated_session, play
from chessboard_vision_tpu_torch.tools.synth import SynthCamera, bench_corners, initial_occupancy

HEIGHT, WIDTH = 1080, 1920
SCORE_RTOL, SCORE_ATOL = 2e-4, 2e-3  # tests/test_hough_conv.py's tolerance
F32_RTOL, F32_ATOL = 1e-5, 1e-5  # tests/test_torch_pipeline.py's tolerance
EXACT_FIELDS = ("occupancy", "raw_occupancy", "visual_changes", "method", "radius",
                "change_intensity")
CHUNK = 64
DEVICE = "cuda"


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, iters):
    """Mean device ms per call of fn() over iters calls (after a warmup)."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_phase():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"compute capability {cap}, expected (9, 0)")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    phase("device", f"{name}, capability {cap}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)
    return name, smi


def build_phase():
    result = build("score_matmul")
    phase("build", f"score_matmul.cu -> {result.path} in {result.seconds:.2f} s")
    for line in result.log.splitlines():
        if "registers" in line or "spill" in line:
            phase("build", line.strip())


def kernel_phase(pipe, frame, smi):
    """The kernel vs its plain version at the main path's shapes."""
    gray, _ = pipe.preprocess(torch.from_numpy(to_planar(frame)).to(DEVICE))
    planes = edge_planes(gray, pipe.conv_dims).planes_flat
    basis, kvalid = pipe.conv_plan.basis, pipe.conv_plan.kvalid
    g = torch.Generator(device=DEVICE).manual_seed(0)
    rand_a = torch.randn(basis.shape, device=DEVICE, generator=g).to(torch.bfloat16)
    rand_b = torch.randn(planes.shape, device=DEVICE, generator=g).to(torch.bfloat16)
    max_err = 0.0
    for label, a, b in (("frame", basis, planes), ("random", rand_a, rand_b)):
        got = sm.score_matmul(a, b)
        want = sm.score_matmul_reference(a, b)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        torch.testing.assert_close(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)
        gi = torch.argmax(torch.where(kvalid, got, -torch.inf), dim=0)
        wi = torch.argmax(torch.where(kvalid, want, -torch.inf), dim=0)
        flips = (gi != wi).nonzero().flatten().tolist()
        for s in flips:
            phase("kernel", f"{label}: square {s} argmax {gi[s].item()} vs plain "
                  f"{wi[s].item()}; plain scores there {want[gi[s], s].item()!r} / "
                  f"{want[wi[s], s].item()!r}")
        check(not flips, f"{label}: masked first-max argmax differs on squares {flips}")
        phase("kernel", f"{label}: ({a.shape[0]}, {a.shape[1]}) x ({b.shape[0]}, {b.shape[1]}) "
              f"max_abs_err {err!r}, argmax equal on all {b.shape[0]} squares")
    # Alternate plain, kernel, kernel, plain and keep the mean of each.
    plain_ms = kernel_ms = 0.0
    for fn in (sm.score_matmul_reference, sm.score_matmul, sm.score_matmul,
               sm.score_matmul_reference):
        ms = cuda_ms(lambda: fn(basis, planes), 200)
        if fn is sm.score_matmul:
            kernel_ms += ms / 2
        else:
            plain_ms += ms / 2
    phase("kernel", f"score_matmul {kernel_ms * 1e3:.1f} us/call, plain (cuBLAS f32) "
          f"{plain_ms * 1e3:.1f} us/call on {smi}")
    return max_err, kernel_ms, plain_ms


def _compare_outputs(a, b, where):
    for f in tp.StepOutputs._fields:
        x, y = getattr(a, f), getattr(b, f)
        check(x.shape == y.shape and x.dtype == y.dtype, f"{where} {f}: shape/dtype")
        if f in EXACT_FIELDS:
            check(np.array_equal(x, y), f"{where} {f} differs")
        else:
            check(np.isfinite(x).all() and np.allclose(x, y, rtol=F32_RTOL, atol=F32_ATOL),
                  f"{where} {f} not within tolerance")


def pipeline_phase(session, camera, rng, smi):
    pipe = session.pipeline
    occ0 = initial_occupancy()
    occ1 = occ0.copy()
    occ1[4, 1], occ1[4, 3] = False, True  # e2 -> e4
    truth = {(f, r) for f in range(8) for r in range(8) if occ0[f, r]}
    state = pipe.capture_reference(pipe.init_state(), camera.render(occ0, rng))
    state, out = pipe.step(state, camera.render(occ0, rng))
    host = tp.outputs_to_numpy(out)
    check(host.occupancy.shape == (64,), "occupancy shape")
    check(tp.occupancy_to_set(host.occupancy) == truth, "clean-frame occupancy != rendered truth")
    phase("pipeline", f"clean {WIDTH}x{HEIGHT} frame: occupancy equals the rendered truth")

    distinct = [camera.render(occ0, rng) for _ in range(8)] + [
        camera.render(occ1, rng) for _ in range(8)
    ]
    # first half e2 on e2, second half on e4
    frames = np.stack([distinct[(2 * i // CHUNK) * 8 + i % 8] for i in range(CHUNK)])
    # The session's smart-scan set at the start position (occupied squares
    # and legal destinations): a moved piece on a same-shade square can sit
    # under the visual-delta gate, and the session forces these squares.
    s2c = session._smart_scan_set()
    check(set(truth) <= s2c, "smart-scan set misses an occupied square")
    seq_state = state
    seq_outs = []
    for fr in frames:
        seq_state, o = pipe.step(seq_state, fr, squares_to_check=s2c)
        seq_outs.append(tp.outputs_to_numpy(o))
    many_state, many = pipe.step_many(state, frames, squares_to_check=s2c)
    many = tp.outputs_to_numpy(many)
    for i in range(CHUNK):
        _compare_outputs(
            tp.StepOutputs(*(f[i] for f in many)), seq_outs[i], f"step_many frame {i}"
        )
    for x, y in zip(tp.state_to_numpy(seq_state), tp.state_to_numpy(many_state)):
        for a, b in zip(x, y):
            check(a.dtype == b.dtype and (np.array_equal(a, b) or np.allclose(
                a, b, rtol=F32_RTOL, atol=F32_ATOL)), "step_many state differs")
    final = {(f, r) for f in range(8) for r in range(8) if occ1[f, r]}
    check(tp.occupancy_to_set(many.occupancy[-1]) == final, "occupancy after e2e4 != truth")
    phase("pipeline", f"step_many over {CHUNK} frames equals {CHUNK} sequential steps; "
          "final occupancy shows e2e4")

    # Timing: chained steps (state threaded through), device-synchronized.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = state
    for fr in frames[:32]:
        st, o = pipe.step(st, fr, squares_to_check=s2c)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 32
    t0 = time.perf_counter()
    st, o = pipe.step_many(state, frames, squares_to_check=s2c)
    tp.outputs_to_numpy(o)
    many_ms = (time.perf_counter() - t0) * 1e3 / CHUNK
    phase("pipeline", f"{WIDTH}x{HEIGHT} step {step_ms:.3f} ms/frame, step_many(K={CHUNK}) "
          f"{many_ms:.3f} ms/frame incl. upload and readback, on {smi}")
    return step_ms, many_ms


def session_phase(corners, camera, rng):
    session = calibrated_session(corners, (WIDTH, HEIGHT), DEVICE)
    moves = ["e2e4", "e7e5"]
    committed, script, n_frames = play(
        session, camera, moves, rng, log=lambda m: phase("session", m)
    )
    check(committed == moves, f"committed {committed}, scripted {moves}")
    check(session.game.get_fen() == script.fen(),
          f"FEN {session.game.get_fen()} != script {script.fen()}")
    phase("session", f"committed {committed} in {n_frames} frames; FEN {script.fen()}")


def main():
    name, smi = device_phase()
    build_phase()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    rng = np.random.default_rng(0)
    corners = bench_corners(HEIGHT, WIDTH)
    # A calibrated session on the card; its pipeline drives phases 3 and 4.
    session = calibrated_session(corners, (WIDTH, HEIGHT), DEVICE)
    pipe = session.pipeline
    g = pipe.geometry
    camera = SynthCamera(corners, frame_size=(HEIGHT, WIDTH), board_px=g.board_size)
    phase("pipeline", f"geometry: board {g.board_size} px, squares "
          f"{pipe.H}x{pipe.W} pad {g.squares.pad}, basis {tuple(pipe.conv_plan.basis.shape)}")
    max_err, kernel_ms, plain_ms = kernel_phase(pipe, camera.render(initial_occupancy(), rng), smi)

    sm.score_matmul.launches = 0  # count only the main path from here
    step_ms, many_ms = pipeline_phase(session, camera, rng, smi)
    session_phase(corners, camera, rng)
    launches = sm.score_matmul.launches
    check(launches > 0, "the main path never launched score_matmul")

    print(json.dumps({"kernels": [{
        "name": "score_matmul",
        "route": "cuda",
        "source": "chessboard_vision_tpu_torch/kernels/score_matmul.cu",
        "replaces": "chessboard_vision_tpu/ops/hough_conv.py:53",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
