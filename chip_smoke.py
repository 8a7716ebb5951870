#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing a line of its own; any failure raises and exits non-zero before
the last line:

1. device: a CUDA card of compute capability 9.0, its name, and its name
   and power limit as nvidia-smi gives them.
2. build: every kernel of the port (chessboard_vision_tpu_torch/kernels/
   score_matmul.cu, bilateral.cu, clahe.cu) compiled with nvcc for sm_90a,
   one nvcc process each, all started together; the seconds each took and
   nvcc's register, shared-memory and spill lines.
3. kernels vs their plain versions at the 1080p shapes, each timed by its
   device time under torch.profiler (plain, kernel, kernel, plain; the
   kernel's CUDA-event time per call beside it), with the least time the
   card could take (bound) and, where one exists, one PyTorch call that
   computes the same function:
   - B1 score matmul: the real (7168, 3200) Hough basis with the pooled
     planes of a rendered 1920x1080 frame, and random bf16 operands of the
     same shapes; scores within rtol 2e-4 / atol 2e-3, the per-square
     masked first-max argmax equal.
   - B2 bilateral on (3, 980, 980): the rendered board as the enhanced path
     hands it over, and random u8; within one level on at most 1e-4 of
     pixels.
   - B3 CLAHE histograms on the (984, 984) Lab-L pad of that board and on a
     th < 8 image: bit-equal.
   - B4 CLAHE LUT apply on the (984, 984) pad with its real LUTs, and on the
     th < 8 image: bit-equal.
4. plain path: VisionPipeline(device="cuda") on rendered 1920x1080 frames
   of the benchmark's board layout: a clean frame's occupancy equals the
   rendered truth; step_many over 64 frames equals 64 sequential steps
   (bool/i32 exactly, f32 within the CPU tests' tolerance); ms per frame.
   Then the port's GameSession plays e2e4 through on_frame and must commit
   it and reach the script's FEN.
5. enhanced path: the same with VisionPipeline(with_enhancer=True) over 32
   frames, and a session calibrated with "use_enhancer": true.

Kernel launch counts are set to 0 just before each path and read just
after it: the plain path must launch B1 and none of B2-B4, the enhanced
path all four. The line before the last is the kernels' JSON record; the
last line is ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import time
import warnings

import numpy as np
import torch

from chessboard_vision_tpu_torch.kernels import bilateral as kb
from chessboard_vision_tpu_torch.kernels import build_all
from chessboard_vision_tpu_torch.kernels import clahe as kc
from chessboard_vision_tpu_torch.kernels import score_matmul as sm
from chessboard_vision_tpu_torch.models import pipeline as tp
from chessboard_vision_tpu_torch.models.enhancer import correct_lighting
from chessboard_vision_tpu_torch.ops import enhance as tenh
from chessboard_vision_tpu_torch.ops import matmul_resample as mr
from chessboard_vision_tpu_torch.ops.color import planar_bgr2lab
from chessboard_vision_tpu_torch.ops.hough_conv import edge_planes
from chessboard_vision_tpu_torch.ops.layout import to_planar
from chessboard_vision_tpu_torch.tools.demo_pipeline import calibrated_session, play
from chessboard_vision_tpu_torch.tools.synth import SynthCamera, bench_corners, initial_occupancy

HEIGHT, WIDTH = 1080, 1920
SCORE_RTOL, SCORE_ATOL = 2e-4, 2e-3  # tests/test_hough_conv.py's tolerance
BILATERAL_FRACTION = 1e-4  # tests/test_torch_kernels.py's tolerance
F32_RTOL, F32_ATOL = 1e-5, 1e-5  # tests/test_torch_pipeline.py's tolerance
EXACT_FIELDS = ("occupancy", "raw_occupancy", "visual_changes", "method", "radius",
                "change_intensity")
CHUNK, ENHANCED_CHUNK = 64, 32
DEVICE = "cuda"
KERNELS = ("score_matmul", "bilateral", "clahe")
# The card's published peaks (H100 SXM data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS, F32_FLOPS = 989e12, 67e12
# f32 operations of one bilateral tap besides its exp: 3 channel
# differences, 2 adds of their magnitudes, cd * cd * gc, the space weight,
# 3 products and 3 sums of the numerators, 1 sum of the denominator.
BILATERAL_FLOPS_PER_TAP = 15
BILATERAL_TAPS = 69  # the d=9 disk


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, iters):
    """Mean ms per call of fn() between two CUDA events around iters calls
    (after a warmup): the device's time when it never waits for the host,
    else the host's issue rate."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters):
    """Mean device-busy ms per call of fn(): the kernels' and copies' own
    time from torch.profiler over iters calls (after a warmup), which gaps
    while the host issues the next call do not inflate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():  # one profiling cycle: its notice does not apply
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
    return busy_us / 1e3 / iters


def kernel_vs_plain_ms(kernel, plain, iters):
    """Device ms per call of the kernel and of its plain version, measured in
    turns (plain, kernel, kernel, plain), and the kernel's CUDA-event ms."""
    ms = {kernel: 0.0, plain: 0.0}
    for fn in (plain, kernel, kernel, plain):
        ms[fn] += device_ms(fn, iters) / 2
    return ms[kernel], ms[plain], cuda_ms(kernel, iters)


def bound(nbytes, flops, flops_per_s):
    """Least ms for the work: bytes at the memory rate vs operations at the
    peak rate of their type, whichever is larger, and which it was."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    t0 = time.perf_counter()
    results = build_all(KERNELS)
    phase("build", f"{len(KERNELS)} sources built in parallel in "
          f"{time.perf_counter() - t0:.2f} s wall")
    for name, result in results.items():
        phase("build", f"{name}.cu -> {result.path} in {result.seconds:.2f} s")
        for line in result.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                phase("build", f"{name}: {line.strip()}")


def score_matmul_phase(pipe, frame, smi):
    """B1 vs its plain version at the main path's shapes."""
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
        phase("kernel", f"score_matmul {label}: ({a.shape[0]}, {a.shape[1]}) x ({b.shape[0]}, "
              f"{b.shape[1]}) max_abs_err {err!r}, argmax equal on all {b.shape[0]} squares")
    kernel_ms, plain_ms, event_ms = kernel_vs_plain_ms(
        lambda: sm.score_matmul(basis, planes), lambda: sm.score_matmul_reference(basis, planes),
        200)
    # The library call for the same function: cuBLAS's bf16 GEMM with f32
    # output where this torch has out_dtype, else its bf16-output GEMM.
    pf_t = planes.T
    try:
        torch.mm(basis, pf_t, out_dtype=torch.float32)
        library = ("torch.mm(bf16, bf16, out_dtype=float32)",
                   lambda: torch.mm(basis, pf_t, out_dtype=torch.float32))
    except (TypeError, RuntimeError):  # no out_dtype, or not for this device
        library = ("torch.mm(bf16, bf16) -> bf16", lambda: torch.mm(basis, pf_t))
    library_ms = device_ms(library[1], 200)
    (M, K), N = basis.shape, planes.shape[0]
    bound_ms, bound_by = bound(2 * M * K + 2 * N * K + 4 * M * N, 2 * M * N * K, BF16_FLOPS)
    phase("kernel", f"score_matmul device {kernel_ms * 1e3:.1f} us/call (CUDA events "
          f"{event_ms * 1e3:.1f} us), plain (cuBLAS f32) {plain_ms * 1e3:.1f} us, {library[0]} "
          f"{library_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us ({bound_by}) on {smi}")
    return dict(name="score_matmul", route="cuda",
                source="chessboard_vision_tpu_torch/kernels/score_matmul.cu",
                replaces="chessboard_vision_tpu/ops/hough_conv.py:53",
                max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def enhancement_kernels_phase(pipe, frame, smi):
    """B2-B4 vs their plain versions at the enhanced path's 1080p shapes."""
    planar = torch.from_numpy(to_planar(frame)).to(DEVICE)
    board = mr.warp_board_color(planar, pipe._tile_plan, pipe._tile_dims, pipe._tile_index)
    board = correct_lighting(board)  # what the bilateral is handed on the path
    g = torch.Generator(device=DEVICE).manual_seed(1)
    rand = torch.randint(0, 256, board.shape, device=DEVICE, generator=g, dtype=torch.uint8)
    records = []

    bil_err = 0
    for label, img in (("board", board), ("random", rand)):
        d = (kb.bilateral_planar(img).int() - kb.bilateral_reference(img).int()).abs()
        torch.cuda.synchronize()
        frac = float((d > 0).float().mean())
        bil_err = max(bil_err, int(d.max()))
        phase("kernel", f"bilateral {label} {tuple(img.shape)}: max_abs_err {int(d.max())}, "
              f"{frac!r} of pixels differ")
        check(int(d.max()) <= 1 and frac <= BILATERAL_FRACTION,
              f"bilateral {label}: kernel vs plain beyond one level on {BILATERAL_FRACTION}")
    kernel_ms, plain_ms, event_ms = kernel_vs_plain_ms(
        lambda: kb.bilateral_planar(board), lambda: kb.bilateral_reference(board), 20)
    C, H, W = board.shape
    bound_ms, bound_by = bound(2 * C * H * W, BILATERAL_TAPS * BILATERAL_FLOPS_PER_TAP * H * W,
                               F32_FLOPS)
    phase("kernel", f"bilateral device {kernel_ms * 1e3:.1f} us/call (CUDA events "
          f"{event_ms * 1e3:.1f} us), plain {plain_ms * 1e3:.1f} us, bound "
          f"{bound_ms * 1e3:.1f} us ({bound_by}), no library call, on {smi}")
    records.append(dict(name="bilateral", route="cuda",
                        source="chessboard_vision_tpu_torch/kernels/bilateral.cu",
                        replaces="chessboard_vision_tpu/ops/pallas/bilateral.py:87",
                        max_abs_err=bil_err, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=None))

    # B3/B4 on the Lab-L reflect pad of the board (984 x 984, th = 123) and
    # on a th < 8 image (40 x 64 -> th = 5, tw = 8).
    tiles = 8
    lab_l = planar_bgr2lab(board)[0]
    th, tw = -(-H // tiles), -(-W // tiles)
    pad = tenh._reflect_pad_end(lab_l, th * tiles, tw * tiles)
    small = torch.randint(0, 256, (40, 64), device=DEVICE, generator=g, dtype=torch.uint8)
    cases = (("board", pad, th, tw), ("th<8", small, 5, 8))
    luts = {}
    for label, img, a, b in cases:
        hist = kc.clahe_hist(img, a, b, tiles)
        torch.cuda.synchronize()
        check(torch.equal(hist, kc.clahe_hist_reference(img, a, b, tiles)),
              f"clahe_hist {label}: kernel differs from plain")
        area = a * b
        luts[label] = tenh.clahe_luts_from_hist(hist, area, max(int(3.0 * area / 256), 1))
        out = kc.clahe_apply(img, luts[label], a, b, tiles)
        torch.cuda.synchronize()
        check(torch.equal(out, kc.clahe_apply_reference(img, luts[label], a, b, tiles)),
              f"clahe_apply {label}: kernel differs from plain")
        phase("kernel", f"clahe_hist and clahe_apply {label} {tuple(img.shape)} th={a}: "
              "bit-equal to plain")
    Hp, Wp = pad.shape
    n_lut = tiles * tiles * 256

    def bincount():  # the library call: one bincount of tile * 256 + value keys
        ty = torch.arange(Hp, device=DEVICE) // th
        tx = torch.arange(Wp, device=DEVICE) // tw
        keys = (ty[:, None] * tiles + tx[None, :]) * 256 + pad.long()
        return torch.bincount(keys.reshape(-1), minlength=n_lut)

    kernel_ms, plain_ms, event_ms = kernel_vs_plain_ms(
        lambda: kc.clahe_hist(pad, th, tw, tiles),
        lambda: kc.clahe_hist_reference(pad, th, tw, tiles), 200)
    library_ms = device_ms(bincount, 200)
    bound_ms, bound_by = bound(Hp * Wp + 4 * n_lut, Hp * Wp, F32_FLOPS)
    phase("kernel", f"clahe_hist device {kernel_ms * 1e3:.1f} us/call (CUDA events "
          f"{event_ms * 1e3:.1f} us), plain {plain_ms * 1e3:.1f} us, torch.bincount (keys built "
          f"in the call) {library_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us ({bound_by}) "
          f"on {smi}")
    records.append(dict(name="clahe_hist", route="cuda",
                        source="chessboard_vision_tpu_torch/kernels/clahe.cu",
                        replaces="chessboard_vision_tpu/ops/pallas/clahe_apply.py:148",
                        max_abs_err=0, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms))

    lut = luts["board"]
    kernel_ms, plain_ms, event_ms = kernel_vs_plain_ms(
        lambda: kc.clahe_apply(pad, lut, th, tw, tiles),
        lambda: kc.clahe_apply_reference(pad, lut, th, tw, tiles), 200)
    # ~10 f32 operations a pixel: the two tile coordinates' fma, fraction
    # and weights, two blends of two terms, the column sum, the round.
    bound_ms, bound_by = bound(2 * Hp * Wp + 4 * n_lut, 10 * Hp * Wp, F32_FLOPS)
    phase("kernel", f"clahe_apply device {kernel_ms * 1e3:.1f} us/call (CUDA events "
          f"{event_ms * 1e3:.1f} us), plain {plain_ms * 1e3:.1f} us, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}), no library call, on {smi}")
    records.append(dict(name="clahe_apply", route="cuda",
                        source="chessboard_vision_tpu_torch/kernels/clahe.cu",
                        replaces="chessboard_vision_tpu/ops/pallas/clahe_apply.py:264",
                        max_abs_err=0, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=None))
    return records


def _compare_outputs(a, b, where):
    for f in tp.StepOutputs._fields:
        x, y = getattr(a, f), getattr(b, f)
        check(x.shape == y.shape and x.dtype == y.dtype, f"{where} {f}: shape/dtype")
        if f in EXACT_FIELDS:
            check(np.array_equal(x, y), f"{where} {f} differs")
        else:
            check(np.isfinite(x).all() and np.allclose(x, y, rtol=F32_RTOL, atol=F32_ATOL),
                  f"{where} {f} not within tolerance")


def pipeline_phase(session, camera, rng, chunk, label, smi):
    pipe = session.pipeline
    occ0 = initial_occupancy()
    occ1 = occ0.copy()
    occ1[4, 1], occ1[4, 3] = False, True  # e2 -> e4
    truth = {(f, r) for f in range(8) for r in range(8) if occ0[f, r]}
    state = pipe.capture_reference(pipe.init_state(), camera.render(occ0, rng))
    state, out = pipe.step(state, camera.render(occ0, rng))
    host = tp.outputs_to_numpy(out)
    check(host.occupancy.shape == (64,), "occupancy shape")
    got = tp.occupancy_to_set(host.occupancy)
    for sq in sorted(got ^ truth):
        i = sq[1] * 8 + sq[0]
        phase(label, f"square {sq}: occupied {bool(host.occupancy[i])}, truth {sq in truth}, "
              f"method {int(host.method[i])}, radius {int(host.radius[i])}, "
              f"confidence {float(host.confidence[i])!r}")
    check(got == truth, f"{label}: clean-frame occupancy != rendered truth")
    phase(label, f"clean {WIDTH}x{HEIGHT} frame: occupancy equals the rendered truth")

    distinct = [camera.render(occ0, rng) for _ in range(8)] + [
        camera.render(occ1, rng) for _ in range(8)
    ]
    # first half e2 on e2, second half on e4
    frames = np.stack([distinct[(2 * i // chunk) * 8 + i % 8] for i in range(chunk)])
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
    for i in range(chunk):
        _compare_outputs(
            tp.StepOutputs(*(f[i] for f in many)), seq_outs[i], f"{label} step_many frame {i}"
        )
    for x, y in zip(tp.state_to_numpy(seq_state), tp.state_to_numpy(many_state)):
        for a, b in zip(x, y):
            check(a.dtype == b.dtype and (np.array_equal(a, b) or np.allclose(
                a, b, rtol=F32_RTOL, atol=F32_ATOL)), f"{label}: step_many state differs")
    final = {(f, r) for f in range(8) for r in range(8) if occ1[f, r]}
    check(tp.occupancy_to_set(many.occupancy[-1]) == final, f"{label}: occupancy after e2e4 != truth")
    phase(label, f"step_many over {chunk} frames equals {chunk} sequential steps; "
          "final occupancy shows e2e4")

    # Timing: chained steps (state threaded through), device-synchronized.
    n = chunk // 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = state
    for fr in frames[:n]:
        st, o = pipe.step(st, fr, squares_to_check=s2c)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n
    t0 = time.perf_counter()
    st, o = pipe.step_many(state, frames, squares_to_check=s2c)
    tp.outputs_to_numpy(o)
    many_ms = (time.perf_counter() - t0) * 1e3 / chunk
    phase(label, f"{WIDTH}x{HEIGHT} step {step_ms:.3f} ms/frame, step_many(K={chunk}) "
          f"{many_ms:.3f} ms/frame incl. upload and readback, on {smi}")
    return step_ms, many_ms


def session_phase(corners, camera, rng, label, use_enhancer):
    session = calibrated_session(corners, (WIDTH, HEIGHT), DEVICE, use_enhancer=use_enhancer)
    check(session.pipeline.with_enhancer == use_enhancer, f"{label}: session pipeline kind")
    moves = ["e2e4"]
    committed, script, n_frames = play(
        session, camera, moves, rng, log=lambda m: phase(label, m)
    )
    check(committed == moves, f"{label}: committed {committed}, scripted {moves}")
    check(session.game.get_fen() == script.fen(),
          f"{label}: FEN {session.game.get_fen()} != script {script.fen()}")
    phase(label, f"session committed {committed} in {n_frames} frames; FEN {script.fen()}")


COUNTERS = {
    "score_matmul": sm.score_matmul,
    "bilateral": kb.bilateral_planar,
    "clahe_hist": kc.clahe_hist,
    "clahe_apply": kc.clahe_apply,
}


def run_path(label, use_enhancer, corners, camera, rng, chunk, smi):
    """Drive one path (pipeline, then session) with every count set to 0
    just before it; returns the counts read just after it."""
    session = calibrated_session(corners, (WIDTH, HEIGHT), DEVICE, use_enhancer=use_enhancer)
    for fn in COUNTERS.values():
        fn.launches = 0
    pipeline_phase(session, camera, rng, chunk, label, smi)
    session_phase(corners, camera, rng, label, use_enhancer)
    counts = {name: fn.launches for name, fn in COUNTERS.items()}
    phase(label, f"kernel launches on this path: {counts}")
    return counts


def main():
    name, smi = device_phase()
    build_phase()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    rng = np.random.default_rng(0)
    corners = bench_corners(HEIGHT, WIDTH)
    # An enhanced pipeline on the card for the kernel phases: its tile plan
    # and conv plan give the kernels the main path's inputs.
    pipe = calibrated_session(corners, (WIDTH, HEIGHT), DEVICE, use_enhancer=True).pipeline
    g = pipe.geometry
    camera = SynthCamera(corners, frame_size=(HEIGHT, WIDTH), board_px=g.board_size)
    phase("kernel", f"geometry: board {g.board_size} px, squares {pipe.H}x{pipe.W} pad "
          f"{g.squares.pad}, basis {tuple(pipe.conv_plan.basis.shape)}, board tiles "
          f"{pipe._tile_dims.q_rows}x{pipe._tile_dims.q_cols}")
    frame = camera.render(initial_occupancy(), rng)
    records = [score_matmul_phase(pipe, frame, smi)]
    records += enhancement_kernels_phase(pipe, frame, smi)

    plain = run_path("plain", False, corners, camera, rng, CHUNK, smi)
    check(plain["score_matmul"] > 0, "the plain path never launched score_matmul")
    check(not any(plain[k] for k in ("bilateral", "clahe_hist", "clahe_apply")),
          "the plain path launched an enhancement kernel")
    enhanced = run_path("enhanced", True, corners, camera, rng, ENHANCED_CHUNK, smi)
    missing = [k for k, n in enhanced.items() if n == 0]
    check(not missing, f"the enhanced path never launched {missing}")

    for rec in records:
        rec["launches"] = plain[rec["name"]] + enhanced[rec["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in records]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
