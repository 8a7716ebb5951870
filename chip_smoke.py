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
     masked first-max argmax equal, two launches bit-equal, and the launch
     took the TMA + wgmma kernel. Its device time is also taken with the L2
     cache flushed before each call (a 200 MB read), beside the library
     call's, to show whether the timing loop finds the basis in L2.
   - B2 bilateral on (3, 980, 980): the rendered board as the enhanced path
     hands it over from an HWC frame on the card (the gather warp, lit),
     and random u8; bit-equal to the plain version, two launches
     bit-equal, and its color-weight table bit-equal to torch.exp on the
     card.
   B1's and B2's lines give their device time beside that of the kernels'
   earlier designs and the share of the bound it reaches.
   - B3 CLAHE histograms of the reflect pad with the LUTs built from them,
     one launch, on the unpadded (980, 980) Lab-L of that board, on a th < 8
     image and on a constant (980, 980) image: bit-equal to the plain
     version (pad, bincount, torch LUT ops), two launches bit-equal. The
     torch LUT phase that the fused epilogue replaced is timed once.
   - B4 CLAHE LUT apply on the same three unpadded planes with their LUTs:
     bit-equal, two launches bit-equal.
   B3's and B4's lines give their time beside their earlier designs' too.
4. plain path: VisionPipeline(device="cuda") on rendered 1920x1080 frames
   of the benchmark's board layout, each handed over three ways: planar
   host arrays and HWC host arrays (the camera's layout, which the step
   takes planar on the card, as the JAX package's step takes a host frame)
   take the matmul resample, HWC tensors on the card the gather warp. A
   clean frame's occupancy equals the rendered truth in all three; step_many
   over 64 frames equals 64 sequential steps (bool/i32 exactly, f32 within
   the CPU tests' tolerance) and shows e2e4; ms per frame each way. Then
   the port's GameSession plays e2e4 through on_frame and must commit it
   and reach the script's FEN.
5. enhanced path: the same with VisionPipeline(with_enhancer=True) over 32
   frames, and a session calibrated with "use_enhancer": true.
6. exact path: VisionPipeline(hough_backend="exact") on HWC host frames: a
   clean frame equals the truth, step_many over 16 frames equals the
   sequential steps, a GameSession on the exact backend commits e2e4, and
   no kernel launches; square decisions agree with the conv pipeline's on
   the same frames on >= 99.5%; ms a frame of both backends in turns, with
   device busy, ops and host syncs (the exact Canny's convergence
   readbacks) a step.
7. streams path (parallel/multistream.py, parallel/session.py) on rendered
   1080p frames of 16 positions (each a different first move):
   - B1 at N = 8*64 and 16*64 on the pooled planes of 8 and 16 frames:
     each stream's 64 columns bit-equal to that stream's own N = 64
     launch, scores within tolerance of the plain version, the masked
     first-max argmax equal on every square, the TMA kernel taken; device
     time beside torch.mm's and the bound.
   - plain 8 streams: capture and two ticks (per-stream square masks and
     re-reference flags) on HWC host frames, which a shared-geometry tick
     warps by gather as the JAX package's does, equal to 8 single-stream
     pipelines given the same frames on the card (their gather route), occupancy
     equal to each stream's rendered truth; step_chunk(T=8) equal to 8
     sequential ticks; ms a tick, frames/s, device busy, ops and peak
     memory. Plain 16 streams: occupancy equal to the truth on every
     stream, and the same numbers. Every plain tick launches B1 once, on
     the TMA kernel with N*64 columns, and none of B2-B4.
   - exact 8 streams: one tick's occupancy equal to each stream's truth,
     no kernel launched, the tick's host syncs; ms a tick.
   - per-stream geometry, plain and enhanced: 2 rigs, the second's corners
     shifted, equal to two independent pipelines of the same kind.
   - enhanced 8 streams: streams 0 and 5 equal to the single-stream
     enhanced pipeline on the same frames on the card; one tick launches
     B1 once and B2, B3 and B4 once a stream.
   - MultiStreamSession with 8 streams: every stream commits its move and
     reaches its FEN; a checkpoint saved mid-game and resumed into a fresh
     session makes the same commits on the same ticks.

Kernel launch counts are set to 0 just before each path and read just
after it: the plain path must launch B1 and none of B2-B4, the enhanced
path all four, with exactly one B3 (histograms + LUTs) and one B4 launch
per CLAHE call, the exact path none, the streams path all four; B1's
1080p launches must take the TMA kernel. On the exact and streams paths
the counts are set to 0 just before each call of the path's pipelines
and sessions and read just after it, so the pipelines they are compared
with add nothing. The line before the last is the kernels' JSON record
(its launches summed over the paths); the last line is
``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import itertools
import json
import os
import re
import subprocess
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from chessboard_vision_tpu_torch.kernels import bilateral as kb
from chessboard_vision_tpu_torch.kernels import build_all
from chessboard_vision_tpu_torch.kernels import clahe as kc
from chessboard_vision_tpu_torch.kernels import score_matmul as sm
from chessboard_vision_tpu_torch.models import pipeline as tp
from chessboard_vision_tpu_torch.models.enhancer import correct_lighting
from chessboard_vision_tpu_torch.ops import enhance as tenh
from chessboard_vision_tpu_torch.ops import warp as warp_ops
from chessboard_vision_tpu_torch.ops.canny import canny
from chessboard_vision_tpu_torch.ops.color import planar_bgr2lab
from chessboard_vision_tpu_torch.ops.hough_conv import edge_planes
from chessboard_vision_tpu_torch.ops.layout import to_planar
from chessboard_vision_tpu_torch.geometry import BoardGeometry
from chessboard_vision_tpu_torch.ops.layout import positions_to_mask
from chessboard_vision_tpu_torch.parallel import multistream as tms
from chessboard_vision_tpu_torch.parallel.session import MultiStreamSession
from chessboard_vision_tpu_torch.rules import chess as rules_chess
from chessboard_vision_tpu_torch.tools.demo_pipeline import calibrated_session, occupancy_of, play
from chessboard_vision_tpu_torch.utils import checkpoint as ckpt
from chessboard_vision_tpu_torch.tools.synth import SynthCamera, bench_corners, initial_occupancy

HEIGHT, WIDTH = 1080, 1920
SCORE_RTOL, SCORE_ATOL = 2e-4, 2e-3  # tests/test_hough_conv.py's tolerance
F32_RTOL, F32_ATOL = 1e-5, 1e-5  # tests/test_torch_pipeline.py's tolerance
EXACT_FIELDS = ("occupancy", "raw_occupancy", "visual_changes", "method", "radius",
                "change_intensity")
CHUNK, ENHANCED_CHUNK = 64, 32
ALL_SQUARES = {(f, r) for f in range(8) for r in range(8)}
DEVICE = "cuda"
KERNELS = ("score_matmul", "bilateral", "clahe")
# The card's published peaks (H100 SXM data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS, F32_FLOPS = 989e12, 67e12
# f32 operations of one bilateral tap besides its exp: 3 channel
# differences, 2 adds of their magnitudes, cd * cd * gc, the space weight,
# 3 products and 3 sums of the numerators, 1 sum of the denominator.
BILATERAL_FLOPS_PER_TAP = 15
BILATERAL_TAPS = 49  # the d=9 disk: dx^2 + dy^2 <= 16
# Device us per call of the designs before this one (chip_smoke, NVIDIA
# H100 80GB HBM3, 700 W): the lines print the new time beside them.
EARLIER_US = {"score_matmul": 64.6, "bilateral": 51.7, "clahe_hist": 7.2, "clahe_apply": 11.1}
L2_FLUSH_BYTES = 200 * 2**20  # four times the 50 MB L2


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


def device_ms(fn, iters, before=None):
    """Mean device-busy ms per call of fn(): the kernels' and copies' own
    time from torch.profiler over iters calls (after a warmup), which gaps
    while the host issues the next call do not inflate. before(), when
    given, runs ahead of each call and its kernels are left out."""
    return device_profile(fn, iters, before)[0]


def device_profile(fn, iters, before=None):
    """device_ms's busy ms per call, and the device kernels and copies per
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profiled(body):
        with warnings.catch_warnings():  # one profiling cycle: its notice does not apply
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    body()
                torch.cuda.synchronize()
        return {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}, prof

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    skip = profiled(before)[0] if before else set()
    _, prof = profiled((lambda: (before(), fn())) if before else fn)
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.key not in skip]
    busy_us = sum(e.self_device_time_total for e in dev)
    return busy_us / 1e3 / iters, sum(e.count for e in dev) / iters


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
    sass_counts(results["bilateral"].path, "bilateral_kernel", "VABSDIFF4")


def sass_counts(lib, kernel, per):
    """Instructions of one kernel in the built library by opcode, from
    cuobjdump -sass, and each per instruction of `per` (one a tap for the
    bilateral: VABSDIFF4 gives each tap's color distance)."""
    from chessboard_vision_tpu_torch.kernels import _nvcc

    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        phase("build", f"{kernel} SASS: not measured (no cuobjdump)")
        return
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    start = sass.rfind("Function : ", 0, sass.index(kernel))
    end = sass.find("Function : ", start + 1)
    ops = collections.Counter(
        m.group(1).split(".")[0]
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                             sass[start:end if end > 0 else None]))
    n = ops[per]
    top = ", ".join(f"{op} {c} ({c / n:.2f})" for op, c in ops.most_common(10))
    phase("build", f"{kernel} SASS: {sum(ops.values())} instructions, {n} {per}; "
          f"by opcode (per {per}): {top}")


def share(name, bound_ms, kernel_ms):
    return (f"{name} device {kernel_ms * 1e3:.1f} us/call (earlier design "
            f"{EARLIER_US[name]:.1f} us), {bound_ms / kernel_ms:.0%} of its bound")


def library_mm(basis, pf):
    """(label, call) of the library call for B1's function: cuBLAS's bf16
    GEMM with f32 output where this torch has out_dtype, else its
    bf16-output GEMM."""
    pf_t = pf.T
    try:
        torch.mm(basis, pf_t, out_dtype=torch.float32)
        return ("torch.mm(bf16, bf16, out_dtype=float32)",
                lambda: torch.mm(basis, pf_t, out_dtype=torch.float32))
    except (TypeError, RuntimeError):  # no out_dtype, or not for this device
        return "torch.mm(bf16, bf16) -> bf16", lambda: torch.mm(basis, pf_t)


def score_matmul_phase(pipe, frame, smi):
    """B1 vs its plain version at the main path's shapes."""
    gray, _ = pipe.preprocess(on_card(frame))  # HWC: the gather warp
    planes = edge_planes(gray, pipe.consts.conv_dims).planes_flat
    basis, kvalid = pipe.consts.conv_plan.basis, pipe.consts.conv_plan.kvalid
    g = torch.Generator(device=DEVICE).manual_seed(0)
    rand_a = torch.randn(basis.shape, device=DEVICE, generator=g).to(torch.bfloat16)
    rand_b = torch.randn(planes.shape, device=DEVICE, generator=g).to(torch.bfloat16)
    max_err = 0.0
    for label, a, b in (("frame", basis, planes), ("random", rand_a, rand_b)):
        got = sm.score_matmul(a, b)
        path = sm.score_matmul.last_path
        again = sm.score_matmul(a, b)
        want = sm.score_matmul_reference(a, b)
        torch.cuda.synchronize()
        check(path == "tma", f"score_matmul {label}: the 1080p launch took the {path} kernel")
        check(torch.equal(got, again), f"score_matmul {label}: two launches differ")
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
              f"{b.shape[1]}) on the {path} kernel, max_abs_err {err!r}, two launches "
              f"bit-equal, argmax equal on all {b.shape[0]} squares")
    kernel_ms, plain_ms, event_ms = kernel_vs_plain_ms(
        lambda: sm.score_matmul(basis, planes), lambda: sm.score_matmul_reference(basis, planes),
        200)
    library = library_mm(basis, planes)
    library_ms = device_ms(library[1], 200)
    # The same two with the L2 cache flushed before each call: a read of
    # L2_FLUSH_BYTES leaves no basis line (and nothing dirty) in L2.
    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=DEVICE)
    cold_ms = device_ms(lambda: sm.score_matmul(basis, planes), 50, before=flush.sum)
    library_cold_ms = device_ms(library[1], 50, before=flush.sum)
    del flush
    (M, K), N = basis.shape, planes.shape[0]
    bound_ms, bound_by = bound(2 * M * K + 2 * N * K + 4 * M * N, 2 * M * N * K, BF16_FLOPS)
    phase("kernel", f"{share('score_matmul', bound_ms, kernel_ms)} (CUDA events "
          f"{event_ms * 1e3:.1f} us), plain (cuBLAS f32) {plain_ms * 1e3:.1f} us, {library[0]} "
          f"{library_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us ({bound_by}); L2 flushed "
          f"before each call: kernel {cold_ms * 1e3:.1f} us, library {library_cold_ms * 1e3:.1f}"
          f" us; on {smi}")
    return dict(name="score_matmul", route="cuda",
                source="chessboard_vision_tpu_torch/kernels/score_matmul.cu",
                replaces="chessboard_vision_tpu/ops/hough_conv.py:53",
                max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def enhancement_kernels_phase(pipe, frame, smi):
    """B2-B4 vs their plain versions at the enhanced path's 1080p shapes."""
    # The HWC camera frame's board from the gather warp, lit as the path
    # lights it: what the bilateral is handed on the path.
    board = warp_ops.frame_to_board(on_card(frame), pipe.consts.dg)
    board = correct_lighting(board.movedim(-1, -3))
    g = torch.Generator(device=DEVICE).manual_seed(1)
    rand = torch.randint(0, 256, board.shape, device=DEVICE, generator=g, dtype=torch.uint8)
    records = []

    table = kb.color_weight_table(board.device)
    check(torch.equal(table, kb.color_weight_table_reference(device=board.device)),
          "bilateral: the color-weight table differs from torch.exp on the card")
    bil_err = 0
    for label, img in (("board", board), ("random", rand)):
        got, again = kb.bilateral_planar(img), kb.bilateral_planar(img)
        d = (got.int() - kb.bilateral_reference(img).int()).abs()
        torch.cuda.synchronize()
        bil_err = max(bil_err, int(d.max()))
        phase("kernel", f"bilateral {label} {tuple(img.shape)}: max_abs_err {int(d.max())}, "
              f"{int((d > 0).sum())} pixels differ, two launches bit-equal "
              f"{torch.equal(got, again)}")
        check(int(d.max()) == 0, f"bilateral {label}: kernel differs from plain")
        check(torch.equal(got, again), f"bilateral {label}: two launches differ")
    kernel_ms, plain_ms, event_ms = kernel_vs_plain_ms(
        lambda: kb.bilateral_planar(board), lambda: kb.bilateral_reference(board), 20)
    C, H, W = board.shape
    bound_ms, bound_by = bound(2 * C * H * W, BILATERAL_TAPS * BILATERAL_FLOPS_PER_TAP * H * W,
                               F32_FLOPS)
    phase("kernel", f"{share('bilateral', bound_ms, kernel_ms)} (CUDA events "
          f"{event_ms * 1e3:.1f} us), plain {plain_ms * 1e3:.1f} us, bound "
          f"{bound_ms * 1e3:.1f} us ({bound_by}), no library call; color-weight table "
          f"bit-equal to torch.exp; on {smi}")
    records.append(dict(name="bilateral", route="cuda",
                        source="chessboard_vision_tpu_torch/kernels/bilateral.cu",
                        replaces="chessboard_vision_tpu/ops/pallas/bilateral.py:87",
                        max_abs_err=bil_err, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=None))

    # B3/B4 on the unpadded Lab-L of the board (980 x 980, th = 123), on a
    # th < 8 image (37 x 61 -> th = 5, tw = 8) and on a constant board-sized
    # plane (every tile in one bin: the atomics' worst case, the largest
    # clip excess).
    tiles = 8
    lab_l = planar_bgr2lab(board)[0]
    small = torch.randint(0, 256, (37, 61), device=DEVICE, generator=g, dtype=torch.uint8)
    flat = torch.full_like(lab_l, 77)
    for label, img in (("board", lab_l), ("th<8", small), ("constant", flat)):
        h, w = img.shape
        a, b = -(-h // tiles), -(-w // tiles)
        clip = max(int(3.0 * a * b / 256), 1)
        got, again = kc.clahe_hist_luts(img, a, b, tiles, clip), kc.clahe_hist_luts(
            img, a, b, tiles, clip)
        want = kc.clahe_hist_luts_reference(img, a, b, tiles, clip)
        out, out2 = (kc.clahe_apply(img, got[1], a, b, tiles) for _ in range(2))
        torch.cuda.synchronize()
        for i, what in enumerate(("histograms", "LUTs")):
            check(torch.equal(got[i], want[i]), f"clahe_hist_luts {label}: {what} differ from plain")
            check(torch.equal(got[i], again[i]), f"clahe_hist_luts {label}: two launches differ")
        check(torch.equal(out, kc.clahe_apply_reference(img, want[1], a, b, tiles)),
              f"clahe_apply {label}: kernel differs from plain")
        check(torch.equal(out, out2), f"clahe_apply {label}: two launches differ")
        phase("kernel", f"clahe_hist_luts and clahe_apply {label} {tuple(img.shape)} th={a} "
              f"tw={b}: bit-equal to plain, two launches of each bit-equal")
    H, W = lab_l.shape
    th, tw = -(-H // tiles), -(-W // tiles)
    clip = max(int(3.0 * th * tw / 256), 1)
    Hp, Wp = th * tiles, tw * tiles
    n_lut = tiles * tiles * 256
    pad = kc.reflect_pad_end(lab_l, Hp, Wp)

    def bincount():  # the library call: one bincount of tile * 256 + value keys
        ty = torch.arange(Hp, device=DEVICE) // th
        tx = torch.arange(Wp, device=DEVICE) // tw
        keys = (ty[:, None] * tiles + tx[None, :]) * 256 + pad.long()
        return torch.bincount(keys.reshape(-1), minlength=n_lut)

    kernel_ms, plain_ms, event_ms = kernel_vs_plain_ms(
        lambda: kc.clahe_hist_luts(lab_l, th, tw, tiles, clip),
        lambda: kc.clahe_hist_luts_reference(lab_l, th, tw, tiles, clip), 200)
    library_ms = device_ms(bincount, 200)
    hist_only_ms = device_ms(lambda: kc.clahe_hist(lab_l, th, tw, tiles), 200)
    hist, lut = kc.clahe_hist_luts(lab_l, th, tw, tiles, clip)
    lut_phase_ms = device_ms(lambda: kc.clahe_luts_from_hist(hist, th * tw, clip), 200)
    # Bytes: the plane read once, the i32 histograms and f32 LUTs written;
    # operations: one count per padded pixel.
    bound_ms, bound_by = bound(H * W + 8 * n_lut, Hp * Wp, F32_FLOPS)
    phase("kernel", f"{share('clahe_hist', bound_ms, kernel_ms)} with its LUT epilogue (the "
          f"earlier design counted only; CUDA events {event_ms * 1e3:.1f} us), the same kernel "
          f"without the epilogue (clahe_hist) {hist_only_ms * 1e3:.1f} us, plain (pad + bincount "
          f"+ LUT ops) {plain_ms * 1e3:.1f} us, torch.bincount of the pad's keys (keys built in "
          f"the call) {library_ms * 1e3:.1f} us, the torch LUT phase the epilogue replaced "
          f"{lut_phase_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us ({bound_by}) on {smi}")
    records.append(dict(name="clahe_hist", route="cuda",
                        source="chessboard_vision_tpu_torch/kernels/clahe.cu",
                        replaces="chessboard_vision_tpu/ops/pallas/clahe_apply.py:148",
                        max_abs_err=0, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms))

    kernel_ms, plain_ms, event_ms = kernel_vs_plain_ms(
        lambda: kc.clahe_apply(lab_l, lut, th, tw, tiles),
        lambda: kc.clahe_apply_reference(lab_l, lut, th, tw, tiles), 200)
    # ~10 f32 operations a pixel: the two tile coordinates' fma, fraction
    # and weights, two blends of two terms, the column sum, the round.
    bound_ms, bound_by = bound(2 * H * W + 4 * n_lut, 10 * H * W, F32_FLOPS)
    phase("kernel", f"{share('clahe_apply', bound_ms, kernel_ms)} (CUDA events "
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


def _check_clean(host, truth, where):
    """A clean frame's occupancy equals the rendered truth; each square
    that differs is printed first."""
    check(host.occupancy.shape == (64,), f"{where}: occupancy shape")
    got = tp.occupancy_to_set(host.occupancy)
    for sq in sorted(got ^ truth):
        i = sq[1] * 8 + sq[0]
        phase(where, f"square {sq}: occupied {bool(host.occupancy[i])}, truth {sq in truth}, "
              f"method {int(host.method[i])}, radius {int(host.radius[i])}, "
              f"confidence {float(host.confidence[i])!r}")
    check(got == truth, f"{where}: clean-frame occupancy != rendered truth")


def on_card(frames):
    """Host frames as a tensor on the card: a pipeline keeps a tensor's
    layout, so an HWC one takes the gather warp."""
    return torch.from_numpy(np.ascontiguousarray(frames)).to(DEVICE)


def step_many_matches_steps(pipe, state, frames, s2c, where):
    """step_many over frames equals the sequential steps (bool/i32 exactly,
    f32 within tolerance, and the final states); returns the host outputs
    of the sequential steps."""
    seq_state, seq_outs = state, []
    for fr in frames:
        seq_state, o = pipe.step(seq_state, fr, squares_to_check=s2c)
        seq_outs.append(tp.outputs_to_numpy(o))
    many_state, many = pipe.step_many(state, frames, squares_to_check=s2c)
    many = tp.outputs_to_numpy(many)
    for i in range(len(frames)):
        _compare_outputs(tp.StepOutputs(*(f[i] for f in many)), seq_outs[i],
                         f"{where} step_many frame {i}")
    for x, y in zip(tp.state_to_numpy(seq_state), tp.state_to_numpy(many_state)):
        for a, b in zip(x, y):
            check(a.dtype == b.dtype and (np.array_equal(a, b) or np.allclose(
                a, b, rtol=F32_RTOL, atol=F32_ATOL)), f"{where}: step_many state differs")
    return seq_outs


def chained_ms(pipe, state, frames, s2c):
    """ms a frame of chained steps (state threaded through), on the host
    clock with the device synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fr in frames:
        state, _ = pipe.step(state, fr, squares_to_check=s2c)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(frames)


def pipeline_phase(session, camera, rng, chunk, label, smi):
    """The session's pipeline on the same frames three ways: planar host
    arrays, HWC host arrays (taken planar on the card: the matmul resample)
    and HWC tensors on the card (the gather warp). A clean frame's
    occupancy equals the truth each way, step_many equals sequential steps,
    and e2e4 shows; ms a frame each way."""
    pipe = session.pipeline
    occ0 = initial_occupancy()
    occ1 = occ0.copy()
    occ1[4, 1], occ1[4, 3] = False, True  # e2 -> e4
    truth, final = _occ_set(occ0), _occ_set(occ1)
    state = pipe.capture_reference(pipe.init_state(), camera.render(occ0, rng))
    clean = camera.render(occ0, rng)
    clean_occ = {}
    for layout, fr in (("planar", to_planar(clean)), ("HWC on the card", on_card(clean)),
                       ("HWC", clean)):
        state_l, out = pipe.step(state, fr)
        host = tp.outputs_to_numpy(out)
        _check_clean(host, truth, f"{label} {layout}")
        clean_occ[layout] = host.occupancy
    state = state_l
    check(all(np.array_equal(o, clean_occ["HWC"]) for o in clean_occ.values()),
          f"{label}: the clean frame's occupancy differs between the layouts")
    phase(label, f"clean {WIDTH}x{HEIGHT} frame as planar and HWC host arrays (matmul "
          "resample) and as an HWC tensor on the card (gather warp): occupancy equals the "
          "rendered truth each way")

    distinct = [camera.render(occ0, rng) for _ in range(8)] + [
        camera.render(occ1, rng) for _ in range(8)
    ]
    # first half e2 on e2, second half on e4
    hwc = np.stack([distinct[(2 * i // chunk) * 8 + i % 8] for i in range(chunk)])
    # The session's smart-scan set at the start position (occupied squares
    # and legal destinations): a moved piece on a same-shade square can sit
    # under the visual-delta gate, and the session forces these squares.
    s2c = session._smart_scan_set()
    check(set(truth) <= s2c, "smart-scan set misses an occupied square")
    for layout, frames in (("HWC", hwc), ("planar", np.ascontiguousarray(np.moveaxis(hwc, -1, 1))),
                           ("HWC on the card", on_card(hwc))):
        outs = step_many_matches_steps(pipe, state, frames, s2c, f"{label} {layout}")
        check(tp.occupancy_to_set(outs[-1].occupancy) == final,
              f"{label} {layout}: occupancy after e2e4 != truth")
        step_ms = chained_ms(pipe, state, frames[: chunk // 2], s2c)
        t0 = time.perf_counter()
        _, o = pipe.step_many(state, frames, squares_to_check=s2c)
        tp.outputs_to_numpy(o)
        many_ms = (time.perf_counter() - t0) * 1e3 / chunk
        phase(label, f"{layout} frames: step_many over {chunk} frames equals {chunk} sequential "
              f"steps, final occupancy shows e2e4; {WIDTH}x{HEIGHT} step {step_ms:.3f} ms/frame, "
              f"step_many(K={chunk}) {many_ms:.3f} ms/frame incl. upload (none for frames on "
              f"the card) and readback, on {smi}")


def session_phase(corners, camera, rng, label, use_enhancer, hough_backend="auto"):
    session = calibrated_session(corners, (WIDTH, HEIGHT), DEVICE, use_enhancer=use_enhancer,
                                 hough_backend=hough_backend)
    check(session.pipeline.with_enhancer == use_enhancer, f"{label}: session pipeline kind")
    if hough_backend == "auto":  # conv on the card, as the pipeline's docstring says
        hough_backend = "conv" if torch.device(DEVICE).type == "cuda" else "exact"
    check(session.pipeline.hough_backend == hough_backend,
          f"{label}: the session's Hough backend is {session.pipeline.hough_backend}")
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
    "clahe_hist_luts": kc.clahe_hist_luts,
    "clahe_apply": kc.clahe_apply,
}
# The path's wrapper of each kernel of the JSON record, where the names
# differ: the path reaches B3's kernel through clahe_hist_luts.
PATH_WRAPPER = {"clahe_hist": "clahe_hist_luts"}


@contextlib.contextmanager
def counted(total):
    """Every launch count set to 0 just before the block and read just after
    it: the block's counts go into the yielded dict and are added to the
    Counter ``total``."""
    for fn in COUNTERS.values():
        fn.launches = 0
    got = {}
    yield got
    got.update({name: fn.launches for name, fn in COUNTERS.items()})
    total.update(got)


def check_tick(got, n, label, enhanced=False):
    """One tick of n streams: B1 once, on the TMA kernel with n*64 columns;
    B2, B3 (through clahe_hist_luts) and B4 once a stream when enhanced,
    else not at all."""
    k = n if enhanced else 0
    want = {"score_matmul": 1, "bilateral": k, "clahe_hist": 0, "clahe_hist_luts": k,
            "clahe_apply": k}
    check(got == want, f"{label}: launches in one tick {got}, want {want}")
    path, shape = sm.score_matmul.last_path, sm.score_matmul.last_shape
    check(path == "tma" and shape[1] == n * 64,
          f"{label}: B1 took the {path} kernel at (M, N, K) {shape}, want N = {n * 64} on tma")


def run_path(label, use_enhancer, corners, camera, rng, chunk, smi):
    """Drive one path (pipeline, then session) with every count set to 0
    just before it; returns the counts read just after it, with the path's
    CLAHE calls under "clahe_calls"."""
    session = calibrated_session(corners, (WIDTH, HEIGHT), DEVICE, use_enhancer=use_enhancer)
    clahe = tenh.clahe
    calls = [0]

    def counted_clahe(*args, **kwargs):
        calls[0] += 1
        return clahe(*args, **kwargs)

    tenh.clahe = counted_clahe  # the enhancer looks it up on the module at each call
    try:
        for fn in COUNTERS.values():
            fn.launches = 0
        pipeline_phase(session, camera, rng, chunk, label, smi)
        session_phase(corners, camera, rng, label, use_enhancer)
        counts = {name: fn.launches for name, fn in COUNTERS.items()}
    finally:
        tenh.clahe = clahe
    counts["clahe_calls"] = calls[0]
    phase(label, f"kernel launches on this path: {counts}")
    return counts


EXACT_FRAMES = 16  # the exact phase's sequence: half on the start position, half after e2e4
# Chained steps timed per turn. The exact step is ~6300 device ops: the
# profiler's post-processing takes ~1 s per 1000 of them, so the exact
# step is profiled over 2 steps only.
TIMED_EXACT = 8


def exact_phase(corners, camera, rng, smi):
    """The exact Hough backend on rendered 1080p HWC host frames, with every
    count set to 0 just before its calls and read just after: a clean
    frame's occupancy equals the truth, step_many equals sequential steps,
    a GameSession on the exact backend commits e2e4, and no kernel
    launches (the exact backend is plain torch; B1 is conv's). Then the
    conv pipeline on the same frames: square decisions agree on >= 99.5%
    (tests/test_regression_clip.py's bar), and both backends' ms a frame
    (in turns), device busy, ops and host syncs a step."""
    occ0 = initial_occupancy()
    occ1 = occ0.copy()
    occ1[4, 1], occ1[4, 3] = False, True  # e2 -> e4
    ref, clean = camera.render(occ0, rng), camera.render(occ0, rng)
    frames = np.stack([camera.render(o, rng)
                       for o in [occ0] * (EXACT_FRAMES // 2) + [occ1] * (EXACT_FRAMES // 2)])
    with counted(collections.Counter()) as got:
        session = calibrated_session(corners, (WIDTH, HEIGHT), DEVICE, hough_backend="exact")
        pipe = session.pipeline
        check(pipe.hough_backend == "exact" and pipe.consts.conv_plan is None,
              "exact: the pipeline built the conv backend")
        state = pipe.capture_reference(pipe.init_state(), ref)
        state, out = pipe.step(state, clean)
        exact_occ = [tp.outputs_to_numpy(out).occupancy]
        _check_clean(tp.outputs_to_numpy(out), _occ_set(occ0), "exact")
        s2c = session._smart_scan_set()
        outs = step_many_matches_steps(pipe, state, frames, s2c, "exact")
        check(tp.occupancy_to_set(outs[-1].occupancy) == _occ_set(occ1),
              "exact: occupancy after e2e4 != truth")
        exact_occ += [o.occupancy for o in outs]
        session_phase(corners, camera, rng, "exact", False, hough_backend="exact")
    check(not any(got.values()), f"the exact path launched kernels: {got}")
    phase("exact", f"clean frame equals the truth, step_many over {EXACT_FRAMES} frames equals "
          f"{EXACT_FRAMES} sequential steps, e2e4 shows and the session committed it; "
          f"kernel launches on this path: {got}")

    conv = tp.VisionPipeline(pipe.geometry, hough_backend="conv", device=DEVICE)
    cstate = conv.capture_reference(conv.init_state(), ref)
    cstate, out = conv.step(cstate, clean)
    conv_occ = [tp.outputs_to_numpy(out).occupancy]
    st = cstate
    for fr in frames:
        st, out = conv.step(st, fr, squares_to_check=s2c)
        conv_occ.append(tp.outputs_to_numpy(out).occupancy)
    differ = int(sum((a != b).sum() for a, b in zip(exact_occ, conv_occ)))
    agreement = 1.0 - differ / (64 * len(exact_occ))
    check(agreement >= 0.995, f"exact vs conv: {agreement:.2%} of square decisions agree")

    ms, syncs = {"conv": 0.0, "exact": 0.0}, {"conv": 0, "exact": 0}
    runs = {"conv": (conv, cstate), "exact": (pipe, state)}
    for name in ("conv", "exact", "exact", "conv"):
        before = canny.host_syncs
        ms[name] += chained_ms(*runs[name], frames[:TIMED_EXACT], s2c) / 2
        syncs[name] += canny.host_syncs - before
    lines = []
    for name, (p, st) in runs.items():
        it = itertools.cycle(frames)
        busy, ops = device_profile(lambda: p.step(st, next(it), squares_to_check=s2c), 2)
        lines.append(f"{name} {ms[name]:.3f} ms/frame, device busy {busy:.3f} ms "
                     f"({busy / ms[name]:.1%}), {ops:.0f} device kernels+copies, "
                     f"{syncs[name] / (2 * TIMED_EXACT):.2f} host syncs a step")
    phase("exact", f"exact vs conv on the same {len(exact_occ)} frames: {agreement:.2%} of square "
          f"decisions agree ({differ} differ); {WIDTH}x{HEIGHT} chained steps: "
          f"{'; '.join(lines)}; on {smi}")


# The first moves of the streams' 16 positions; the session plays the first 8.
STREAM_MOVES = ("e2e4", "d2d4", "g1f3", "c2c4", "b1c3", "e2e3", "d2d3", "g2g3",
                "b2b3", "f2f4", "a2a4", "h2h4", "c2c3", "f2f3", "b2b4", "h2h3")
TIMED_TICKS = 10
SESSION_SAVE_TICK = 10  # the session's checkpoint, mid-game (commits come ~20 ticks in)


def render_all(camera, occs, seed):
    """One frame of each occupancy, each from its own seed, rendered in
    threads (numpy's array loops let go of the interpreter lock)."""
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(lambda i: camera.render(occs[i], np.random.default_rng((seed, i))),
                             range(len(occs))))


def b1_wide_phase(basis, kvalid, planes, smi):
    """B1 at N = 8*64 and 16*64 on the pooled planes of 8 and 16 rendered
    frames: each stream's 64 columns bit-equal to its own N = 64 launch,
    scores within tolerance of the plain version, the masked first-max
    argmax equal on every square; device time beside the library call's
    and the bound."""
    (M, K), max_err = basis.shape, 0.0
    for n in (8, 16):
        pf = planes[: n * 64]
        got = sm.score_matmul(basis, pf)
        check(sm.score_matmul.last_path == "tma",
              f"score_matmul N={n * 64}: took the {sm.score_matmul.last_path} kernel")
        for i in range(n):
            own = sm.score_matmul(basis, pf[i * 64:(i + 1) * 64])
            check(torch.equal(got[:, i * 64:(i + 1) * 64], own),
                  f"score_matmul N={n * 64}: stream {i}'s columns differ from its N=64 launch")
        want = sm.score_matmul_reference(basis, pf)
        torch.testing.assert_close(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        kv = kvalid.repeat(1, n)
        gi = torch.argmax(torch.where(kv, got, -torch.inf), dim=0)
        wi = torch.argmax(torch.where(kv, want, -torch.inf), dim=0)
        flips = (gi != wi).nonzero().flatten().tolist()
        check(not flips, f"score_matmul N={n * 64}: argmax differs on squares {flips}")
        library = library_mm(basis, pf)
        kernel_ms, library_ms, event_ms = kernel_vs_plain_ms(
            lambda: sm.score_matmul(basis, pf), library[1], 100)
        bound_ms, bound_by = bound(2 * M * K + 2 * n * 64 * K + 4 * M * n * 64,
                                   2 * M * n * 64 * K, BF16_FLOPS)
        phase("streams", f"score_matmul N={n * 64} ({n} streams): ({M}, {K}) x ({n * 64}, {K}) "
              f"on the tma kernel, each stream's columns bit-equal to its N=64 launch, "
              f"max_abs_err {err!r}, argmax equal on all {n * 64} squares; device "
              f"{kernel_ms * 1e3:.1f} us/call (CUDA events {event_ms * 1e3:.1f} us), "
              f"{library[0]} {library_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us "
              f"({bound_by}), {bound_ms / kernel_ms:.0%} of its bound; on {smi}")
    return max_err


def _occ_set(occ):
    return {(f, r) for f in range(8) for r in range(8) if occ[f, r]}


def _all_masks(n):
    return np.ones((n, 64), bool)


def _stream_outputs(host, s):
    return tp.StepOutputs(*(f[s] for f in host.step))


def streams_vs_single(ms, single, ref, ticks, label, launches):
    """Capture, then step ``ms`` (plain) through ticks of (frames, masks,
    refresh) and each stream through the single-stream pipeline ``single``
    with a state of its own: every stream's outputs must equal its
    pipeline's, and each tick launches B1 once. ``ms``'s launches go into
    ``launches``. Returns (state, host outputs of the last tick). The
    shared-geometry tick warps HWC host frames by gather; the single
    pipelines take those frames as tensors on the card, their gather route."""
    n = ms.n_streams
    with counted(launches):
        state = ms.capture_reference(ms.init_state(), ref)
    singles = [single.capture_reference(single.init_state(), on_card(ref[s])) for s in range(n)]
    for t, (frames, masks, refresh) in enumerate(ticks):
        with counted(launches) as got:
            state, out = ms.step(state, frames, s2c_masks=masks, refresh=refresh)
        check_tick(got, n, f"{label} tick {t}")
        host = tms.outputs_to_numpy(out)
        for s in range(n):
            squares = None if masks is None else tp.occupancy_to_set(masks[s])
            singles[s], o = single.step(singles[s], on_card(frames[s]), squares_to_check=squares,
                                        refresh_refs=refresh is not None and bool(refresh[s]))
            _compare_outputs(_stream_outputs(host, s), tp.outputs_to_numpy(o),
                             f"{label} tick {t} stream {s}")
    return state, host


def time_ticks(ms, state, frame_sets, masks, label, smi, ticks=TIMED_TICKS):
    """Chained ticks with fixed square masks, the frame sets in turn: ms a
    tick on the host clock (pack + upload alone, enqueue, wall with the
    drain), aggregate frames/s, device busy and device ops a tick under the
    profiler, peak memory."""
    n = ms.n_streams
    frames = [frame_sets[t % len(frame_sets)] for t in range(ticks)]
    flags = ms._flags((), masks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for fr in frames:
        tp.upload(fr, flags, ms.device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for fr in frames:
        state, _ = ms.step(state, fr, s2c_masks=masks)
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    k = len(frames)
    pack_ms, enqueue_ms, wall_ms = ((t1 - t0) * 1e3 / k, (t2 - t1) * 1e3 / k, (t3 - t1) * 1e3 / k)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    box, it = [state], itertools.cycle(frame_sets)

    def tick():
        box[0], _ = ms.step(box[0], next(it), s2c_masks=masks)

    busy_ms, ops = device_profile(tick, 5)
    phase("streams", f"{label}: {wall_ms:.3f} ms/tick ({n * 1e3 / wall_ms:.1f} frames/s "
          f"aggregate; host pack+upload {pack_ms:.3f} ms, step enqueue incl. pack "
          f"{enqueue_ms:.3f} ms), device busy {busy_ms:.3f} ms/tick ({busy_ms / wall_ms:.1%} "
          f"of the wall), {ops:.0f} device kernels+copies/tick, peak memory "
          f"{peak_gb:.3f} GB (torch.cuda.max_memory_allocated); on {smi}")
    return box[0]


def streams_phase(corners, camera, g, enhanced_pipe, smi):
    """The N-stream path at 1080p: B1 at wide N, then plain 8 and 16
    streams, per-stream geometry, enhanced 8 streams and an 8-stream
    session with a checkpoint resume, with the launch counts set to 0 just
    before each call of the path and read just after it. Returns (the
    path's counts, B1's max error)."""
    boards = []
    for uci in STREAM_MOVES:
        b = rules_chess.Board()
        b.push_uci(uci)
        boards.append(b)
    occs = [occupancy_of(b) for b in boards]
    occ0 = initial_occupancy()
    t0 = time.perf_counter()
    sets = [render_all(camera, occs, seed) for seed in (10, 11)]  # 2 frames a position
    initial = render_all(camera, [occ0] * 3, 12)
    phase("streams", f"rendered {2 * len(occs) + 3} frames of {WIDTH}x{HEIGHT} in "
          f"{time.perf_counter() - t0:.1f} s")
    ref16 = np.stack([initial[s % 3] for s in range(16)])
    ms16 = tms.MultiStreamPipeline(g, 16, device=DEVICE)
    check(ms16.consts.conv_plan.kvalid.shape[1] == 1024, "folded kvalid width")
    frames16, _ = tp.upload(np.stack(sets[0]), np.zeros(0, bool), ms16.device)
    gray, _ = ms16._squares(frames16)
    planes = edge_planes(gray, ms16.consts.conv_dims).planes_flat
    b1_err = b1_wide_phase(ms16.pipe.consts.conv_plan.basis, ms16.pipe.consts.conv_plan.kvalid,
                           planes, smi)
    del frames16, gray, planes

    launches = collections.Counter()
    single = tp.VisionPipeline(g, device=DEVICE)
    ms8 = tms.MultiStreamPipeline(g, 8, device=DEVICE)
    ref8 = ref16[:8]
    smart = np.stack([positions_to_mask(_occ_set(o)) for o in occs[:8]])
    ticks = [(np.stack(sets[0][:8]), _all_masks(8), None),
             (np.stack(sets[1][:8]), smart, np.arange(8) % 2 == 0)]
    state, host = streams_vs_single(ms8, single, ref8, ticks, "plain 8 streams", launches)
    for s in range(8):
        check(tp.occupancy_to_set(host.step.occupancy[s]) == _occ_set(occs[s]),
              f"plain 8 streams: stream {s} occupancy != rendered truth")
    phase("streams", "plain 8 streams: capture + 2 ticks (per-stream masks and re-reference "
          "flags) equal 8 single-stream pipelines; every stream's occupancy equals its "
          "rendered truth")
    chunk = np.stack([np.stack(sets[t % 2][:8]) for t in range(8)])
    seq = tms.multistream_state_from_numpy(tms.multistream_state_to_numpy(state), DEVICE)
    with counted(launches) as got:
        state, many = ms8.step_chunk(state, chunk)
    want = dict.fromkeys(COUNTERS, 0) | {"score_matmul": 8}
    check(got == want, f"step_chunk(T=8): launches {got}, want {want}")
    many = tms.outputs_to_numpy(many)
    check(many.step.occupancy.shape == (8, 8, 64), "step_chunk output shape")
    for t in range(8):
        with counted(launches) as got:
            seq, o = ms8.step(seq, chunk[t])
        check_tick(got, 8, f"plain 8 streams sequential tick {t}")
        o = tms.outputs_to_numpy(o)
        _compare_outputs(tp.StepOutputs(*(f[t] for f in many.step)), o.step,
                         f"step_chunk tick {t}")
        for f in o.noise._fields:
            check(np.array_equal(getattr(many.noise, f)[t], getattr(o.noise, f)),
                  f"step_chunk tick {t} noise {f} differs")
    for a, b in zip(tms.multistream_state_to_numpy(seq), tms.multistream_state_to_numpy(state)):
        for x, y in zip(ckpt.tree_leaves(a), ckpt.tree_leaves(b)):
            check(x.dtype == y.dtype and (np.array_equal(x, y) or np.allclose(
                x, y, rtol=F32_RTOL, atol=F32_ATOL)), "step_chunk state differs")
    phase("streams", "step_chunk(T=8) of 8 streams equals 8 sequential ticks")
    del chunk
    with counted(launches):
        state = time_ticks(ms8, state, [np.stack(fs[:8]) for fs in sets], smart,
                           "plain 8 streams", smi)
    del ms8, state, seq

    frames = np.stack(sets[0])
    with counted(launches):
        state = ms16.capture_reference(ms16.init_state(), ref16)
    with counted(launches) as got:
        state, out = ms16.step(state, frames, s2c_masks=_all_masks(16))
    check_tick(got, 16, "plain 16 streams")
    host = tms.outputs_to_numpy(out)
    for s in range(16):
        check(tp.occupancy_to_set(host.step.occupancy[s]) == _occ_set(occs[s]),
              f"plain 16 streams: stream {s} occupancy != rendered truth")
    phase("streams", "plain 16 streams: every stream's occupancy equals its rendered truth")
    smart16 = np.stack([positions_to_mask(_occ_set(o)) for o in occs])
    with counted(launches):
        time_ticks(ms16, state, [np.stack(fs) for fs in sets], smart16, "plain 16 streams", smi)
    del ms16, state

    ms_exact = tms.MultiStreamPipeline(g, 8, hough_backend="exact", device=DEVICE)
    with counted(launches):
        state = ms_exact.capture_reference(ms_exact.init_state(), ref8)
    syncs = canny.host_syncs
    with counted(launches) as got:
        state, out = ms_exact.step(state, np.stack(sets[0][:8]), s2c_masks=_all_masks(8))
    syncs = canny.host_syncs - syncs
    check(not any(got.values()), f"exact 8 streams: launches in one tick {got}, want none")
    host = tms.outputs_to_numpy(out)
    for s in range(8):
        check(tp.occupancy_to_set(host.step.occupancy[s]) == _occ_set(occs[s]),
              f"exact 8 streams: stream {s} occupancy != rendered truth")
    phase("streams", f"exact 8 streams: every stream's occupancy equals its rendered truth; one "
          f"tick launched no kernel and made {syncs} host syncs")
    ticks = [np.stack(fs[:8]) for fs in sets]
    with counted(launches) as got:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for fr in ticks:
            state, _ = ms_exact.step(state, fr, s2c_masks=_all_masks(8))
        torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) * 1e3 / len(ticks)
    check(not any(got.values()), f"exact 8 streams: the timed ticks launched {got}")
    phase("streams", f"exact 8 streams: {tick_ms:.3f} ms/tick ({8e3 / tick_ms:.1f} frames/s "
          f"aggregate; {len(ticks)} chained ticks incl. upload), on {smi}")
    del ms_exact, state

    corners2 = corners + np.array([[14, 9], [-11, 6], [8, -7], [-12, -10]])
    g2 = BoardGeometry.from_calibration(corners2, display_size=(WIDTH, HEIGHT))
    camera2 = SynthCamera(corners2, frame_size=(HEIGHT, WIDTH), board_px=g2.board_size)
    ref2, step2 = render_all(camera2, [occ0, occs[1]], 13)
    refs, frames = np.stack([initial[0], ref2]), np.stack([sets[0][0], step2])
    for enhanced in (False, True):
        kind = "enhanced" if enhanced else "plain"
        ms2 = tms.MultiStreamPipeline([g, g2], 2, with_enhancer=enhanced, device=DEVICE)
        with counted(launches):
            state = ms2.capture_reference(ms2.init_state(), refs)
        with counted(launches) as got:
            state, out = ms2.step(state, frames, s2c_masks=_all_masks(2))
        check_tick(got, 2, f"{kind} per-stream geometry", enhanced)
        host = tms.outputs_to_numpy(out)
        for s, geo in enumerate((g, g2)):
            # Per-stream plans resample planar frames (the N-stream step
            # permutes HWC ones): the single pipelines get the same.
            pipe = tp.VisionPipeline(geo, with_enhancer=enhanced, device=DEVICE)
            st = pipe.capture_reference(pipe.init_state(), to_planar(refs[s]))
            st, o = pipe.step(st, to_planar(frames[s]), squares_to_check=ALL_SQUARES)
            _compare_outputs(_stream_outputs(host, s), tp.outputs_to_numpy(o),
                             f"{kind} per-stream geometry stream {s}")
            check(tp.occupancy_to_set(host.step.occupancy[s]) == _occ_set(occs[s]),
                  f"{kind} per-stream geometry: stream {s} occupancy != rendered truth")
        phase("streams", f"{kind} per-stream geometry (2 rigs, the second's corners shifted): "
              f"outputs equal two independent {kind} pipelines and the rendered truth; one "
              f"tick launched {got}")
        del ms2, state

    ms_enh = tms.MultiStreamPipeline(g, 8, with_enhancer=True, device=DEVICE)
    with counted(launches):
        state = ms_enh.capture_reference(ms_enh.init_state(), ref8)
    with counted(launches) as per_tick:
        state, out = ms_enh.step(state, np.stack(sets[0][:8]), s2c_masks=_all_masks(8))
    check_tick(per_tick, 8, "enhanced 8 streams", enhanced=True)
    host = tms.outputs_to_numpy(out)
    for s in (0, 5):
        st = enhanced_pipe.capture_reference(enhanced_pipe.init_state(), on_card(ref8[s]))
        st, o = enhanced_pipe.step(st, on_card(sets[0][s]), squares_to_check=ALL_SQUARES)
        _compare_outputs(_stream_outputs(host, s), tp.outputs_to_numpy(o),
                         f"enhanced 8 streams stream {s}")
    phase("streams", f"enhanced 8 streams: streams 0 and 5 equal the single-stream enhanced "
          f"pipeline; one tick launched {per_tick}")
    with counted(launches):
        time_ticks(ms_enh, state, [np.stack(fs[:8]) for fs in sets], _all_masks(8),
                   "enhanced 8 streams", smi, ticks=5)
    del ms_enh, state

    with counted(launches):  # the session's calls alone launch kernels in this phase
        multistream_session_phase(g, sets, initial)
    counts = {name: launches[name] for name in COUNTERS}
    phase("streams", f"kernel launches on this path: {counts}")
    return counts, b1_err


def multistream_session_phase(g, sets, initial):
    """8 games on one MultiStreamSession, each playing its own first move;
    a checkpoint saved mid-game and resumed into a fresh session makes the
    same commits on the same ticks."""
    scripts = []
    for uci in STREAM_MOVES[:8]:
        b = rules_chess.Board()
        b.push_uci(uci)
        scripts.append(b)

    def session():
        sess = MultiStreamSession(g, 8, device=DEVICE)
        sess.MOVE_COOLDOWN = 0.0
        return sess

    def tick_frames(t):
        return np.stack([sets[t % 2][s] for s in range(8)])

    sess = session()
    sess.capture_reference(np.stack([initial[s % 3] for s in range(8)]))
    for t in range(3):
        check(not any(sess.on_frames(np.stack([initial[(t + s) % 3] for s in range(8)]))),
              "session: a move committed on the start position")
    log, committed = [], [None] * 8
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "streams.npz")
        for t in range(45):
            if t == SESSION_SAVE_TICK:
                check(not any(committed), "session: committed before the checkpoint tick")
                sess.save_checkpoint(path)
            moves = [m and m.uci() for m in sess.on_frames(tick_frames(t))]
            log.append(moves)
            for s, m in enumerate(moves):
                if m:
                    check(committed[s] is None, f"session: stream {s} committed twice")
                    committed[s] = (m, t)
            if all(committed):
                break
        check(all(committed), f"session: commits {committed}")
        resumed = session()
        resumed.resume_checkpoint(path)
        relog = [[m and m.uci() for m in resumed.on_frames(tick_frames(t))]
                 for t in range(SESSION_SAVE_TICK, len(log))]
    check(relog == log[SESSION_SAVE_TICK:], "session: the resumed session's commits differ")
    for s, b in enumerate(scripts):
        check(committed[s][0] == STREAM_MOVES[s], f"session: stream {s} committed "
              f"{committed[s][0]}, scripted {STREAM_MOVES[s]}")
        for sess_ in (sess, resumed):
            check(sess_.streams[s].game.get_fen() == b.fen(), f"session: stream {s} FEN")
    phase("streams", f"MultiStreamSession (8 streams): every stream committed its scripted "
          f"move (ticks {[c[1] for c in committed]}) and reached its FEN; a checkpoint of tick "
          f"{SESSION_SAVE_TICK} resumed into a fresh session made the same commits")


def main():
    t_start = time.perf_counter()

    def elapsed(what):
        phase("time", f"{what} done at {time.perf_counter() - t_start:.0f} s")

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
          f"{g.squares.pad}, basis {tuple(pipe.consts.conv_plan.basis.shape)}, board tiles "
          f"{pipe._tile_dims.q_rows}x{pipe._tile_dims.q_cols}")
    frame = camera.render(initial_occupancy(), rng)
    records = [score_matmul_phase(pipe, frame, smi)]
    records += enhancement_kernels_phase(pipe, frame, smi)
    elapsed("kernels")

    plain = run_path("plain", False, corners, camera, rng, CHUNK, smi)
    check(plain["score_matmul"] > 0, "the plain path never launched score_matmul")
    check(sm.score_matmul.last_path == "tma",
          f"the plain path's score_matmul took the {sm.score_matmul.last_path} kernel")
    check(not any(plain[k] for k in COUNTERS if k != "score_matmul"),
          "the plain path launched an enhancement kernel")
    enhanced = run_path("enhanced", True, corners, camera, rng, ENHANCED_CHUNK, smi)
    missing = [k for k in COUNTERS if k != "clahe_hist" and enhanced[k] == 0]
    check(not missing, f"the enhanced path never launched {missing}")
    n = enhanced["clahe_calls"]
    check(enhanced["clahe_hist_luts"] == n and enhanced["clahe_apply"] == n
          and enhanced["clahe_hist"] == 0,
          f"the enhanced path's {n} CLAHE calls made {enhanced['clahe_hist_luts']} B3 "
          f"(histograms + LUTs), {enhanced['clahe_hist']} histogram-only and "
          f"{enhanced['clahe_apply']} B4 launches, not one B3 and one B4 each")
    phase("enhanced", f"{n} CLAHE calls, each one B3 and one B4 launch")
    elapsed("plain and enhanced paths")
    exact_phase(corners, camera, rng, smi)
    elapsed("exact path")

    streams, b1_wide_err = streams_phase(corners, camera, g, pipe, smi)
    missing = [k for k in COUNTERS if k != "clahe_hist" and streams[k] == 0]
    check(not missing, f"the streams path never launched {missing}")
    check(streams["clahe_hist"] == 0, "the streams path launched the histogram-only B3")
    records[0]["max_abs_err"] = max(records[0]["max_abs_err"], b1_wide_err)
    elapsed("streams path")

    for rec in records:
        w = PATH_WRAPPER.get(rec["name"], rec["name"])
        rec["launches"] = plain[w] + enhanced[w] + streams[w]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in records]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
