#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing a line of its own; any failure raises and exits non-zero before
the last line:

1. device: a CUDA card of compute capability 9.0, its name, and its name
   and power limit as nvidia-smi gives them.
2. build: every kernel of the port (chessboard_vision_tpu_torch/kernels/
   score_matmul.cu, bilateral.cu, clahe.cu, resample.cu) compiled with
   nvcc for sm_90a, one nvcc process each, all started together; the
   seconds each took and nvcc's register, shared-memory and spill lines.
3. kernels vs their plain versions at the 1080p shapes, each timed by its
   device time under torch.profiler (plain, kernel, kernel, plain; a
   kernel's time is the median of its launches' records, which records
   the profiler drops do not lower, or, where the profiler saw fewer than
   half of them, the median between CUDA events with the stream held
   behind a sleep kernel; that held-stream time beside it, and a "FLAG"
   line and the held time where the two disagree by more than 6 us +
   15%; every profiled window starts with sleep kernels,
   and a line says where it still saw fewer records than launches), with
   the least time the
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
   - B1 at the 720p plans, on their real bases and the pooled planes of 4
     rendered frames, at N = 64 and 256 (1280x720 on the live corners,
     default and radius-extreme settings: Mq 2048 and 3840, K 1250 padded
     with zeros to 1256 on both operands): the TMA kernel taken, each
     stream's columns bit-equal to its N = 64 launch, two launches
     bit-equal, tolerance and argmax as above, device time beside
     torch.mm's, the plain version's and the bound.
   - B3 CLAHE histograms of the reflect pad with the LUTs built from them,
     one launch, on the unpadded (980, 980) Lab-L of that board, on a th < 8
     image and on a constant (980, 980) image: bit-equal to the plain
     version (pad, bincount, torch LUT ops), two launches bit-equal. The
     torch LUT phase that the fused epilogue replaced is timed once.
   - B4 CLAHE LUT apply on the same three unpadded planes with their LUTs:
     bit-equal, two launches bit-equal.
   B3's and B4's lines give their time beside their earlier designs' too.
   Then B2-B4 with a board axis (the enhanced tick's form): 8 rendered
   980^2 boards, at N = 1 and 8 and on a mixed batch of 3 (rendered, random
   u8, constant), each kernel one launch for the N boards, bit-equal to its
   plain version and to N single-board launches; its device time a launch
   and a board at N = 1 and 8 beside N single-board launches, the plain
   version and the bound at N boards.
   Then B2-B4 at the whole 1080x1920 frame (api.enhance_frame's shape):
   B2 on the rendered frame and on random u8 (bit-equal to plain; the
   frame's flat background is a best case for its color-weight lookups),
   B3 and B4 on its Lab-L, each with its device time, the profiler's
   records a call seen, its held-stream CUDA-event time and its bound, B3
   beside torch.bincount of the pad's keys (also at 720x1280 in the ui
   phase).
   Then the resample kernel (kernels/resample.cu, which has no TPU
   counterpart) at the halls' shapes: 8 rigs' square plans on 8 gray
   1080p frames and their tile plans on the planar view of the 8 HWC
   frames, one launch each, bit-equal to the plain chain on the card, its
   device time beside the plain chain's, its bound (the source pixels its
   taps touch and the output) and, apart, its 13-byte plan's read.
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
   frames, and a session calibrated with "use_enhancer": true. Then the
   backend seam at the 1080p board: bilateral_backend="plain" within Queue
   C 7's limits of "kernel" (the bilateral alone and enhance_planar), the
   clahe(backend=) seam the same way, "kernel" on a CPU tensor raising, a
   "plain" enhanced pipeline's bool/i32 outputs equal to the kernel
   pipeline's with no B2 launch.
6. profiler and stages (Queue C 15; utils/profiling.py): windows of 100
   B4 calls and 20 plain 1080p steps, each through device_trace after
   PAD_LAUNCHES sleep kernels, count (a) the runtime's launch and copy calls
   in the Chrome trace and in key_averages, (b) the trace's device records,
   (c) the device events of prof.events() and key_averages, and which
   launches have no record (by correlation); B4's median record in the
   trace and in prof.events() beside its held-stream time; the trace's span
   of the window's records beside CUDA events around them. Then the
   per-stage device ms (aggregate_device_op_ms with STAGE_OF, bench.py's
   stage map on the port's files) of 20 plain steps, 20 enhanced steps and
   10 ticks of 8 plain streams at 1920x1080 on HWC host frames, one window
   each: the stages sum to the trace's device total within 0.1%, B1's
   records land in "hough" and B2-B4's in "enhance", "other" stays under
   10%; each window's total beside step_busy's for the same call.
   Then the bench (tools/bench.py, which holds STAGE_OF) in this process
   at a short length (``--frames 128 --passes 2``, ~90 s), its JSON line
   printed: every key of its line present and every fps > 0, every FEN's
   board the synthetic frame's occupancy, the 8-stream rig's first chunk
   on device-resident buffers equal tick for tick to the same frames as
   host arrays (MultiStreamPipeline taking frames already on the card),
   each per-stage table's total within 3% of step_busy's device time of
   the same steps, and B1-B4 launched.
7. exact path: VisionPipeline(hough_backend="exact") on HWC host frames: a
   clean frame equals the truth, step_many over 16 frames equals the
   sequential steps, a GameSession on the exact backend commits e2e4, and
   no kernel launches; square decisions agree with the conv pipeline's on
   the same frames on >= 99.5%; ms a frame of both backends in turns, with
   device busy, ops and host syncs (the exact Canny's convergence
   readbacks) a step.
8. streams path (parallel/multistream.py, parallel/session.py) on rendered
   1080p frames of 16 positions (each a different first move):
   - B1 at N = 8*64 and 16*64 on the pooled planes of 8 and 16 frames:
     each stream's 64 columns bit-equal to that stream's own N = 64
     launch, two launches bit-equal, scores within tolerance of the plain
     version, the masked first-max argmax equal on every square, the TMA
     kernel taken (128 x 256 CTA tiles); device time beside torch.mm's and
     the bound.
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
     B1 once and B2, B3 and B4 once, each for the 8 boards (so does the
     enhanced per-stream-geometry tick for its 2).
   - MultiStreamSession with 8 streams: every stream commits its move and
     reaches its FEN; a checkpoint saved mid-game and resumed into a fresh
     session makes the same commits on the same ticks.
   - 8 streams with with_change_detector=False beside the default tick:
     every other output bit-equal, the change fields zeros; ms a tick of
     both in turns.
9. mesh path (parallel/mesh.py, the meshed MultiStreamPipeline) on the
   streams phase's 1080p frames, 8 streams, each showing its own first
   move (stream 0: e2e4), on 8 slots spread over the cards
   (``cuda:{i % cards}``: cuda:0 eight times on one card): the dp 8 mesh,
   the dp x sp 4 x 2 mesh, per-stream geometry on dp 8 (the odd rigs'
   corners shifted) and the enhanced dp 8 mesh, each a capture and 3 ticks
   against the unsharded MultiStreamPipeline and one single-stream
   pipeline a stream on the card (bool/i32 exactly, f32 within the CPU
   tests' tolerance, the FSM outputs exactly), every stream's occupancy
   equal to its rendered truth; one base pipeline a distinct device; B1
   once a slot a tick on the TMA kernel at the slot's width (N = 64), B2,
   B3 and B4 once a slot a tick on the enhanced meshes: dp 8 and, for one
   tick, dp x sp 4 x 2, whose slots hold 2 streams each (one launch for a
   slot's boards, not one a stream). Then ms a tick of
   unsharded, dp 8 and 4 x 2 in turns (unsharded, dp 8, 4 x 2, 4 x 2, dp
   8, unsharded) with device busy and ops a tick: on one card the host
   cost of sharding, not a scaling figure.
10. fleet path (parallel/distributed.py, tools/dryrun_multigpu.py): two
   ``--fleet-worker`` processes over Gloo, both on cuda:0, 4 streams of
   1280x720 each on 2 slots each, every rank's occupancy equal to its rows
   of this process's unsharded run and the fleet's all_reduce of
   occupancy equal to its sum (each waited 120 s, killed past it); a
   two-process NCCL fleet where the machine has two cards (else a line
   says why not); then a one-process NCCL group on the card: its
   all_reduce of the 8 streams' occupancy counts equals their sum. Then a
   split-row fleet: two Gloo processes on cuda:0, 3 slots each, a mesh of
   data 3 x space 2, so row 1 spans the processes, 6 streams of 1280x720,
   two ticks (the second with square masks, given wrong by each process
   for the rows it does not own): each owner's rows bit-equal to this
   process's unsharded run in every StepOutputs and FSM field; its wall
   time, and the same over NCCL where the machine has two cards (else a
   line says why not). The phase's wall time is printed.
11. footage path (tools/process_video.py, api.py) on rendered 1920x1080
   frames with piece types (per-square colors, per-type disc radii):
   - process_video.run_capture over a scripted game held in memory (4
     start frames, 28 after e2e4, 28 after e7e5; a reader at 30 fps,
     skip_frames=1, the card has no cv2 to decode a file): commits e2e4 and
     e7e5, reaches the script's FEN, and its JSONL timeline and PGN equal
     the expected text; B1 launches once a processed frame, B2-B4 never.
     ms a processed frame, session.fps and the on_frame p50/p95 of its
     ``session.on_frame`` spans (which end after the wait for the card). With the moves 22 frames apart,
     cooldown_seconds=2.0 (60 frames) drops e7e5 and 0.5 (15 frames)
     keeps it. With "use_enhancer": true the game commits too and all four
     kernels launch, one B3 and one B4 a CLAHE call.
   - api on 1280x720 frames, the capture its geometry assumes (as the
     JAX api's; the benchmark's board layout at that size, a 620 px
     board), a frame pair (start, then e2e4; the default disc size, as
     tests/test_api.py's pair): detect_pieces and frame_to_fen equal the
     rendered truth, detect_changes holds e2 and e4 and at most 8 squares,
     extract_grid gives 64 crops of the CPU's shapes;
     frame_to_full_fen calibrated on the start position reads a midgame
     position exactly; ms a call of each entry point (host clock, the
     median of 5 calls after one). A GameSession on the 1080p footage
     calibrates its piece types on the start position, commits e2e4 and
     verify_position() matches.
   - api.enhance_frame at (1080, 1920), (240, 320) and (719, 1277): at each
     shape B2, B3 and B4 bit-equal to their plain versions on the card
     (CLAHE's 135x240 tiles at 1080p; the odd width takes the apply's byte
     path), the output within ROADMAP Queue C 7's limits of the same call on
     the CPU; ms a call at each shape.
   - PieceDetectorModel on the card: calibrate_reference on the start
     position, get_occupied_squares on the e2e4 frame equals the truth.
   - native.HostResampler, built with g++ here, on the 1080p board plan:
     bit-equal to the port's board warp on the card; ms a frame.

12. live path (tools/play_lichess.py, session/lichess_session.py,
   session/drift.py, native.FrameRing) at 1280x720, the live driver's
   capture, on the board corners of tests/fixtures.DEFAULT_CORNERS
   rendered by tools/synth.SynthCamera:
   - play_lichess.run through the frame ring: a camera thread reads a
     scripted camera at 30 fps into the ring, the loop steps the newest
     frame through a LichessSession on the card with a scripted client (no
     network) and "auto_recalibrate": true: white plays e2e4 (the client
     must receive the POST), the stream answers e7e5, the camera is bumped
     by (12, 7) px and the session must recalibrate to within 2 px of the
     bumped corners, white plays g1f3 at the new corners (committed and
     POSTed); the final FEN is the script's and the PGN holds the three
     moves. Printed: frames stepped, passed over and dropped; on_frame
     p50/p95 with and without a drift check; the recalibration; one drift
     check's image stages on the card, D2H and host contour stages (host
     clock, the card synchronized; no profiler).
   - MultiStreamSession(auto_recalibrate=True) at 1080p on the
     benchmark's layout, 8 plain streams and then 2 enhanced: rig 0
     bumped, one rebuild in per-stream-geometry mode, then every rig
     commits e2e4; the drift check of all rigs and the rebuild timed.

13. ui path (tools/calibrate_piece_detector.py, calibrate_sensitivity.py,
   calibrate_colors.py, enhance_demo.py, calibration_module.py, the
   session's radar) at 1280x720, the tools' capture, on
   tests/fixtures.DEFAULT_CORNERS, through a stand-in for cv2's HighGUI
   (scripted trackbars, keys and clicks; drawing calls recorded, not
   painted; the calibrator's warpPerspective and rotate by the port's warp
   on the card), in a temporary working directory:
   - calibrate_piece_detector.run: the default settings, the radius
     extremes (5% / 80%), then new param1/param2/center_diff, each held 16
     frames: one rebuild a distinct setting, the squares circled at the
     default settings equal the truth, B1 at each rebuilt plan's shape
     within tolerance of its plain version with the argmax equal (the
     path it took printed: the 720p plans, K 1250 padded to 1256, take the
     TMA + wgmma kernel, "tma"),
     and at each distinct plan shape its device time beside the plain
     version's, torch.mm's and the bound;
   - calibrate_sensitivity.run: blur 9 rebuilds the geometry with
     blur_pad 4, then the e2 pawn lifted: the preview marks (4, 1) and
     circles (4, 2), (4, 3);
   - calibrate_colors.run with a non-identity profile: the shown image is
     ImageEnhancer.apply_color_profile of the frame;
   - enhance_demo.run on 8 frames: B2, B3, B4 once a frame each, each
     bit-equal to its plain version at 720x1280 and timed there as phase
     3 times the whole 1080x1920 frame;
   - CalibrationModule.run with four clicks, ENTER, 'g', 's': the config's
     corners are the clicks; GameSession.on_calibration_requested(cap)
     without a saved calibration reaches it and captures the reference on
     the card;
   - a GameSession on the card: e2 lifted is lifted_piece_square (4, 1)
     with destinations (4, 2), (4, 3).
   Each line gives ms a frame (host clock), ms a rebuild (plan build and
   reference capture apart) and the launches.

14. ablation (tools/ablate_enhanced.py at 980^2): B2-B4 in full and with
   parts taken out (extra instantiations of the same kernels), the LUT
   phase, device copies of the same bytes and an empty kernel's launch, by
   held-stream CUDA events over chained calls; then the production B2-B4
   times of phase 3 beside those PERF.md's kernel table recorded before the
   ablation instantiations were added, a "FLAG" line where one moved by
   more than 15%. Its launches are on no main path.

A step's or tick's device busy time and ops (exact, streams) are
torch.profiler's records summed over a window that starts with sleep
kernels, printed with the records seen against the launches
expected (the runtime's launch and copy calls); where records are still
missing, the busy time comes from CUDA events (held stream, or around the
calls as an upper bound for a step that synchronizes).

Kernel launch counts are set to 0 just before each path and read just
after it: the plain path must launch B1 and none of B2-B4, the enhanced
path all four, with exactly one B3 (histograms + LUTs) and one B4 launch
per CLAHE call, the exact path none of B1-B4, the streams path all four, the mesh
path all four (the unsharded pipeline it is compared with and timed
beside counts nothing; the fleet's launches are in its worker
processes), the footage path all four, the live path all four (B2-B4 on the enhanced
streams), the ui path all four, the bench all four; B1's 1080p launches must take
the TMA kernel. Every path must also launch the resample kernel: exactly
once a per-rig tick (a mesh's: once a slot), not at all on a shared-geometry
tick of HWC host frames or in api.enhance_frame and enhance_demo, and at
least once a step where single-board steps take host frames (planar: the
plain, enhanced, exact, footage, live and ui paths). On the exact, streams, mesh, footage, live and ui paths the counts are
set to 0 just before each call of the path's pipelines, sessions, entry
points and tools and read
just after it, so the pipelines and plain versions they are compared with
add nothing. The line before the last is the kernels' JSON record
(its launches summed over the paths); the last line is
``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import functools
import itertools
import json
import os
import queue
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from chessboard_vision_tpu_torch.kernels import bilateral as kb
from chessboard_vision_tpu_torch.kernels import SOURCES, build_all, launch_counters
from chessboard_vision_tpu_torch.kernels import clahe as kc
from chessboard_vision_tpu_torch.kernels import resample as kr
from chessboard_vision_tpu_torch.kernels import score_matmul as sm
from chessboard_vision_tpu_torch.models import pipeline as tp
from chessboard_vision_tpu_torch.models import PieceDetectorModel
from chessboard_vision_tpu_torch.models import enhancer as tenhancer
from chessboard_vision_tpu_torch.models.enhancer import correct_lighting
from chessboard_vision_tpu_torch.ops import enhance as tenh
from chessboard_vision_tpu_torch.ops import matmul_resample as mr
from chessboard_vision_tpu_torch.ops import warp as warp_ops
from chessboard_vision_tpu_torch.ops.canny import canny
from chessboard_vision_tpu_torch.ops.color import bgr2gray, planar_bgr2gray, planar_bgr2lab
from chessboard_vision_tpu_torch.ops.hough_conv import edge_planes
from chessboard_vision_tpu_torch.ops.layout import to_planar
from chessboard_vision_tpu_torch.geometry import BoardGeometry
from chessboard_vision_tpu_torch.ops.layout import positions_to_mask
from chessboard_vision_tpu_torch.parallel import distributed as pdist
from chessboard_vision_tpu_torch.parallel import multistream as tms
from chessboard_vision_tpu_torch.parallel.mesh import make_mesh
from chessboard_vision_tpu_torch import api
from chessboard_vision_tpu_torch import geometry
from chessboard_vision_tpu_torch.parallel.session import MultiStreamSession
from chessboard_vision_tpu_torch.rules import chess as rules_chess
from chessboard_vision_tpu_torch.rules.fen import occupancy_to_fen
from chessboard_vision_tpu_torch.rules.pgn import game_to_pgn
from chessboard_vision_tpu_torch.session.game_session import GameSession
from chessboard_vision_tpu_torch.session.lichess_session import LichessSession
from chessboard_vision_tpu_torch import native
from chessboard_vision_tpu_torch.tools import ablate_enhanced, bench
from chessboard_vision_tpu_torch.tools import dryrun_multigpu, play_lichess, process_video
from chessboard_vision_tpu_torch.tools.bench import STAGE_OF
from chessboard_vision_tpu_torch.tools.demo_pipeline import calibrated_session, occupancy_of, play
from chessboard_vision_tpu_torch.utils import checkpoint as ckpt
from chessboard_vision_tpu_torch.utils.profiling import (
    DEVICE_CATEGORIES,
    LAUNCH_CALLS,
    LAUNCH_CATEGORIES,
    PAD_LAUNCHES,
    FpsCounter,
    aggregate_device_op_ms,
    device_op_rows,
    device_trace,
    load_trace,
    recorded_calls,
    sleep_pads,
    stage_of_frames,
)
from chessboard_vision_tpu_torch.utils.profiling import clear as clear_calls
from chessboard_vision_tpu_torch.tools.synth import (
    SynthCamera,
    bench_corners,
    board_render_maps,
    initial_occupancy,
)

HEIGHT, WIDTH = 1080, 1920
SCORE_RTOL, SCORE_ATOL = 2e-4, 2e-3  # tests/test_hough_conv.py's tolerance
F32_RTOL, F32_ATOL = 1e-5, 1e-5  # tests/test_torch_pipeline.py's tolerance
EXACT_FIELDS = ("occupancy", "raw_occupancy", "visual_changes", "method", "radius",
                "change_intensity")
CHUNK, ENHANCED_CHUNK = 64, 32
ALL_SQUARES = {(f, r) for f in range(8) for r in range(8)}
DEVICE = "cuda"
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
    busy = device_profile(fn, iters, before)[0]
    if busy is None:  # the profiler lost every record: the events' time instead
        phase("time", "torch.profiler saw no device records; CUDA-event time instead")
        busy = cuda_ms(fn, iters)
        if before:
            busy = cuda_ms(lambda: (before(), fn()), iters) - cuda_ms(before, iters)
    return busy


def profiled(body, iters, pad=False):
    """torch.profiler over iters calls of body(), the card synchronized at
    the end: (the device events' keys, the profile). With ``pad``,
    PAD_LAUNCHES sleep kernels run first inside the window (a session
    loses the device records of its first launches: Queue C 15); leave
    their key (pad_keys()) out of what is read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings():  # one profiling cycle: its notice does not apply
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if pad:
                sleep_pads()
            for _ in range(iters):
                body()
            torch.cuda.synchronize()
    return {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}, prof


def records_vs_launches(prof, iters, skip=frozenset()):
    """(device records a call, launches a call) of a padded profile: the
    device events not in ``skip`` or the pads' key, against the runtime's
    launch and copy calls on the host less the pads'."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    keys = pad_keys()
    seen = sum(e.count for e in events if e.device_type == DeviceType.CUDA
               and e.key not in skip and e.key not in keys)
    launches = sum(e.count for e in events
                   if e.device_type == DeviceType.CPU and e.key in LAUNCH_CALLS)
    return seen / iters, (launches - (PAD_LAUNCHES if keys else 0)) / iters


def device_profile(fn, iters, before=None):
    """device_ms's busy ms per call, and the device kernels and copies per
    call; (None, None) when the profiler saw no device record."""
    from torch.autograd import DeviceType

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    skip = profiled(before, iters)[0] if before else set()
    _, prof = profiled((lambda: (before(), fn())) if before else fn, iters, pad=True)
    keys = pad_keys()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and e.key not in skip and e.key not in keys]
    if not dev:
        return None, None
    seen, expected = records_vs_launches(prof, iters, skip)
    if not before and seen < expected:
        phase("time", f"device_ms: {seen:.2f} device records a call seen of {expected:.2f} "
              "launches: the busy time reads low")
    busy_us = sum(e.self_device_time_total for e in dev)
    return busy_us / 1e3 / iters, sum(e.count for e in dev) / iters


@functools.lru_cache(maxsize=1)
def pad_keys():
    """The profiler's key of the pads' sleep kernel, to leave it out. A
    profiling session now and then records nothing (Queue C 15), and an
    empty set cached here would count the pads as the window's own
    records: profile the pads again until a session sees them."""
    for _ in range(5):
        keys = profiled(sleep_pads, 1)[0]
        if keys:
            return frozenset(keys)
    raise RuntimeError("torch.profiler saw no record of the pads' sleep kernels in 5 sessions")


def step_busy(fn, iters):
    """Device busy ms and device ops per call of a step or tick under
    torch.profiler, and a note with the device records it saw against the
    launches it expected (the runtime's launch and copy calls it saw on the
    host), with PAD_LAUNCHES sleep kernels before the calls, left out of
    both. Where it still saw fewer records than launches, their sum
    would read low: the busy time comes from CUDA events instead, held_ms
    (the stream held while every call is enqueued, so the host's gaps do not
    count) or, for a call that waits for the card inside (held_ms cannot
    hold it), cuda_ms around the calls, an upper bound. Returns (busy ms,
    ops, note)."""
    from torch.autograd import DeviceType

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    _, prof = profiled(fn, iters, pad=True)
    keys = pad_keys()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and e.key not in keys]
    seen, expected = records_vs_launches(prof, iters)
    records = f"{seen:.1f} device records a call seen of {expected:.1f} launches"
    if dev and seen >= expected:
        return sum(e.self_device_time_total for e in dev) / 1e3 / iters, seen, records
    try:
        return held_ms(fn, iters), expected, f"held-stream CUDA events; torch.profiler: {records}"
    except RuntimeError:  # the call synchronizes: the stream cannot be held across it
        return (cuda_ms(fn, iters), expected,
                f"CUDA events around the calls, an upper bound; torch.profiler: {records}")


def busy_text(busy, ops, note, wall_ms, per):
    """step_busy's numbers for a line, beside the wall time they share."""
    return (f"device busy {busy:.3f} ms{per} ({busy / wall_ms:.1%} of the wall; {note}), "
            f"{ops:.0f} device kernels+copies{per}")


def held_ms(fn, iters):
    """Median device ms of one call of a wrapper that launches one kernel,
    from CUDA events recorded between the calls while a sleep kernel holds
    the stream: every call is enqueued before the card starts on them, so
    the events bracket the kernel and not the host's launch. Holds longer
    and again if the sleep ended before the host was done."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000  # ~10 ms at the H100's boost clock
    for _ in range(4):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
        held = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        held.record()
        events[0].record()
        for e in events[1:]:
            fn()
            e.record()
        still_held = not held.query()
        torch.cuda.synchronize()
        if still_held:
            return float(np.median([a.elapsed_time(b) for a, b in zip(events, events[1:])]))
        cycles *= 4
    raise RuntimeError(f"held_ms: the host did not enqueue {iters} calls within a held stream")


def launch_ms(fn, iters):
    """Device ms of one call of a wrapper that launches one kernel: the
    median duration of its records under torch.profiler over iters calls
    (after a warmup) in a window that starts with sleep kernels, and the
    records seen a call against the launches a call. A session loses the
    records of its first launches (Queue C 15: once all of 100 unpadded),
    which lowers a busy time per call but not the median; where it saw
    fewer than half of them, the median of held_ms instead."""
    from torch.autograd import DeviceType

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    _, prof = profiled(fn, iters, pad=True)
    keys = pad_keys()
    us = [e.device_time_total for e in prof.events()
          if e.device_type == DeviceType.CUDA and e.name not in keys]
    seen, expected = records_vs_launches(prof, iters)
    check(len(us) <= iters, f"launch_ms: {len(us)} device records for {iters} calls of "
          "a one-kernel wrapper")
    if seen < expected:
        phase("time", f"launch_ms: {seen:.2f} device records a call seen of {expected:.2f} "
              "launches")
    if 2 * len(us) < iters:
        phase("time", f"torch.profiler saw {len(us)} of {iters} launches; held-stream CUDA "
              "events instead")
        return held_ms(fn, iters), seen, expected
    return float(np.median(us)) / 1e3, seen, expected


# How far the profiler's time of a kernel may lie from its held-stream
# CUDA-event time: held_ms also counts the gap between back-to-back
# launches (4 us a call beside B1 and torch.mm at N = 512 and beside B3/B4,
# NVIDIA H100 80GB HBM3), so the two agree within 6 us plus 15%.
HELD_GAP_MS, HELD_SHARE = 0.006, 0.15


def kernel_vs_plain_ms(kernel, plain, iters):
    """Device ms per call of the kernel (launch_ms) and of its plain version
    (device_ms), measured in turns (plain, kernel, kernel, plain), and the
    kernel's held-stream CUDA-event ms (held_ms, no profiler). Where the
    profiler's time and the held one disagree by more than HELD_SHARE of
    the held time plus HELD_GAP_MS (it once read B1 at N = 1024 as 53.7 us
    against 74.1 by CUDA events, and B1 at N = 512 under its bound, Queue
    C 15), a "FLAG" line says so and the held time replaces the profiler's."""
    ms = {kernel: 0.0, plain: 0.0}
    for fn in (plain, kernel, kernel, plain):
        ms[fn] += (launch_ms(fn, iters)[0] if fn is kernel else device_ms(fn, iters)) / 2
    held = held_ms(kernel, iters)
    if abs(ms[kernel] - held) > HELD_SHARE * held + HELD_GAP_MS:
        phase("time", f"FLAG: torch.profiler read {ms[kernel] * 1e3:.2f} us a call, "
              f"held-stream CUDA events {held * 1e3:.2f} us: the held time instead")
        ms[kernel] = held
    return ms[kernel], ms[plain], held


def b1_bound(M, N, K):
    """B1's bound: the operands read once and the f32 scores written once,
    against its bf16 operations."""
    return bound(2 * M * K + 2 * N * K + 4 * M * N, 2 * M * N * K, BF16_FLOPS)


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
    results = build_all(SOURCES)
    phase("build", f"{len(SOURCES)} sources built in parallel in "
          f"{time.perf_counter() - t0:.2f} s wall")
    for name, result in results.items():
        phase("build", f"{name}.cu -> {result.path} in {result.seconds:.2f} s")
        for line in result.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                phase("build", f"{name}: {line.strip()}")
    # The production instantiation (bilateral_kernel<kFull>), not an ablation variant's.
    sass_counts(results["bilateral"].path, "bilateral_kernelILi0EE", "VABSDIFF4")


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
    (M, K), N = basis.shape, planes.shape[0]
    bound_ms, bound_by = b1_bound(M, N, K)
    kernel_ms, plain_ms, held = kernel_vs_plain_ms(
        lambda: sm.score_matmul(basis, planes), lambda: sm.score_matmul_reference(basis, planes),
        200)
    library = library_mm(basis, planes)
    library_ms, library_held = device_ms(library[1], 200), held_ms(library[1], 200)
    # The same two with the L2 cache flushed before each call: a read of
    # L2_FLUSH_BYTES leaves no basis line (and nothing dirty) in L2.
    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=DEVICE)
    cold_ms = device_ms(lambda: sm.score_matmul(basis, planes), 50, before=flush.sum)
    library_cold_ms = device_ms(library[1], 50, before=flush.sum)
    del flush
    phase("kernel", f"{share('score_matmul', bound_ms, kernel_ms)} (held-stream CUDA events "
          f"{held * 1e3:.1f} us), plain (cuBLAS f32) {plain_ms * 1e3:.1f} us, {library[0]} "
          f"{library_ms * 1e3:.1f} us (held-stream {library_held * 1e3:.1f} us), bound {bound_ms * 1e3:.1f} us ({bound_by}); L2 flushed "
          f"before each call: kernel {cold_ms * 1e3:.1f} us, library {library_cold_ms * 1e3:.1f}"
          f" us; on {smi}")
    return dict(name="score_matmul", route="cuda",
                source="chessboard_vision_tpu_torch/kernels/score_matmul.cu",
                replaces="chessboard_vision_tpu/ops/hough_conv.py:53",
                max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def b1_plans_phase(smi):
    """B1 at the 720p plans (default and the radius extremes, K 1250 padded
    to 1256 with zero columns on both operands), each at N = 64 and 256
    (the pooled planes of 4 rendered frames, as the fleet's 4 streams at
    720p hand them over): the TMA kernel taken, every stream's columns
    bit-equal to its own N = 64 launch, two launches bit-equal, within
    tolerance of the plain version, the masked first-max argmax equal on
    every square; device time beside torch.mm's, the plain version's and
    the bound."""
    max_err = 0.0
    cases = (("720p default", None),
             ("720p radius extremes", {"min_radius": 5, "max_radius": 80}))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = BoardGeometry.from_calibration(UI_CORNERS, display_size=(UI_WIDTH, UI_HEIGHT))
    camera = SynthCamera(UI_CORNERS, frame_size=(UI_HEIGHT, UI_WIDTH), board_px=g.board_size)
    frames = [camera.render(initial_occupancy(), np.random.default_rng((60, i)))
              for i in range(4)]
    for label, settings in cases:
        pipe = tp.VisionPipeline(g, piece_settings=settings, device=DEVICE)
        basis, planes = b1_operands(pipe, frames, label)
        (M, K), q = basis.shape, pipe.consts.conv_dims.downsample
        k0 = 2 * (pipe.H // q) * (pipe.W // q)  # the JAX plan's K
        check(K == -(-k0 // 8) * 8 and not basis[:, k0:].any() and not planes[:, k0:].any(),
              f"{label}: basis K {K} for the planes' {k0}: not padded to 8 with zeros")
        kvalid = pipe.consts.conv_plan.kvalid
        own = [sm.score_matmul(basis, planes[i * 64:(i + 1) * 64]) for i in range(4)]
        for n in (64, 256):
            pf = planes[:n]
            got = sm.score_matmul(basis, pf)
            path = sm.score_matmul.last_path
            again = sm.score_matmul(basis, pf)
            want = sm.score_matmul_reference(basis, pf)
            torch.cuda.synchronize()
            check(path == "tma", f"{label} N={n}: B1 took the {path} path")
            check(torch.equal(got, again), f"{label} N={n}: two launches differ")
            for i in range(n // 64):
                check(torch.equal(got[:, i * 64:(i + 1) * 64], own[i]),
                      f"{label} N={n}: stream {i}'s columns differ from its N=64 launch")
            torch.testing.assert_close(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            kv = kvalid.repeat(1, n // 64)
            gi = torch.argmax(torch.where(kv, got, -torch.inf), dim=0)
            wi = torch.argmax(torch.where(kv, want, -torch.inf), dim=0)
            flips = (gi != wi).nonzero().flatten().tolist()
            check(not flips, f"{label} N={n}: argmax differs from plain on squares {flips}")
            bound_ms, bound_by = b1_bound(M, n, K)
            kernel_ms, plain_ms, held = kernel_vs_plain_ms(
                lambda: sm.score_matmul(basis, pf), lambda: sm.score_matmul_reference(basis, pf),
                100)
            library = library_mm(basis, pf)
            library_ms, library_held = device_ms(library[1], 100), held_ms(library[1], 100)
            wg, nt = sm.tile_shape(M, n, sms)
            phase("kernel", f"score_matmul {label} N={n}: ({M}, {K}) x ({n}, {K}) on the {path} "
                  f"path ({64 * wg} x {64 * nt} CTA tiles), each stream's columns bit-equal to "
                  f"its N=64 launch, two launches bit-equal, max_abs_err {err!r}, argmax equal "
                  f"on all {n} squares; device {kernel_ms * 1e3:.2f} us/call (held-stream CUDA "
                  f"events {held * 1e3:.2f} us), plain (cuBLAS f32) {plain_ms * 1e3:.2f} us, "
                  f"{library[0]} {library_ms * 1e3:.2f} us (held-stream "
                  f"{library_held * 1e3:.2f} us), bound {bound_ms * 1e3:.2f} us ({bound_by}), "
                  f"{bound_ms / kernel_ms:.0%} of its bound; on {smi}")
        del pipe, basis, planes, own
    return max_err


def clahe_bincount(lab_l, tiles):
    """B3's library call on a plane: one torch.bincount of tile * 256 +
    value keys of the reflect pad (the keys built in the call)."""
    H, W = lab_l.shape
    th, tw = -(-H // tiles), -(-W // tiles)
    pad = kc.reflect_pad_end(lab_l, th * tiles, tw * tiles)

    def bincount():
        ty = torch.arange(th * tiles, device=lab_l.device) // th
        tx = torch.arange(tw * tiles, device=lab_l.device) // tw
        keys = (ty[:, None] * tiles + tx[None, :]) * 256 + pad.long()
        return torch.bincount(keys.reshape(-1), minlength=tiles * tiles * 256)

    return bincount


def lit_board(pipe, frame):
    """The HWC camera frame's board from the gather warp, lit as the path
    lights it: what the bilateral is handed on the path."""
    board = warp_ops.frame_to_board(on_card(frame), pipe.consts.dg)
    return correct_lighting(board.movedim(-1, -3))


def enhancement_kernels_phase(pipe, frame, smi):
    """B2-B4 vs their plain versions at the enhanced path's 1080p shapes."""
    board = lit_board(pipe, frame)
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
    kernel_ms, plain_ms, held = kernel_vs_plain_ms(
        lambda: kb.bilateral_planar(board), lambda: kb.bilateral_reference(board), 20)
    rand_ms = launch_ms(lambda: kb.bilateral_planar(rand), 20)[0]
    C, H, W = board.shape
    bound_ms, bound_by = bound(2 * C * H * W, BILATERAL_TAPS * BILATERAL_FLOPS_PER_TAP * H * W,
                               F32_FLOPS)
    phase("kernel", f"{share('bilateral', bound_ms, kernel_ms)} (held-stream CUDA events "
          f"{held * 1e3:.1f} us), plain {plain_ms * 1e3:.1f} us, bound "
          f"{bound_ms * 1e3:.1f} us ({bound_by}), no library call; on random u8 of the "
          f"same shape {rand_ms * 1e3:.1f} us ({bound_ms / rand_ms:.0%} of the bound); "
          f"color-weight table bit-equal to torch.exp; on {smi}")
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
    bincount = clahe_bincount(lab_l, tiles)
    kernel_ms, plain_ms, held = kernel_vs_plain_ms(
        lambda: kc.clahe_hist_luts(lab_l, th, tw, tiles, clip),
        lambda: kc.clahe_hist_luts_reference(lab_l, th, tw, tiles, clip), 200)
    library_ms = device_ms(bincount, 200)
    hist_only_ms = launch_ms(lambda: kc.clahe_hist(lab_l, th, tw, tiles), 200)[0]
    hist, lut = kc.clahe_hist_luts(lab_l, th, tw, tiles, clip)
    lut_phase_ms = device_ms(lambda: kc.clahe_luts_from_hist(hist, th * tw, clip), 200)
    # Bytes: the plane read once, the i32 histograms and f32 LUTs written;
    # operations: one count per padded pixel.
    bound_ms, bound_by = bound(H * W + 8 * n_lut, Hp * Wp, F32_FLOPS)
    phase("kernel", f"{share('clahe_hist', bound_ms, kernel_ms)} with its LUT epilogue (the "
          f"earlier design counted only; held-stream CUDA events {held * 1e3:.1f} us), the "
          f"same kernel without the epilogue (clahe_hist) {hist_only_ms * 1e3:.1f} us, plain (pad + bincount "
          f"+ LUT ops) {plain_ms * 1e3:.1f} us, torch.bincount of the pad's keys (keys built in "
          f"the call) {library_ms * 1e3:.1f} us, the torch LUT phase the epilogue replaced "
          f"{lut_phase_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us ({bound_by}) on {smi}")
    records.append(dict(name="clahe_hist", route="cuda",
                        source="chessboard_vision_tpu_torch/kernels/clahe.cu",
                        replaces="chessboard_vision_tpu/ops/pallas/clahe_apply.py:148",
                        max_abs_err=0, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms))

    kernel_ms, plain_ms, held = kernel_vs_plain_ms(
        lambda: kc.clahe_apply(lab_l, lut, th, tw, tiles),
        lambda: kc.clahe_apply_reference(lab_l, lut, th, tw, tiles), 200)
    # ~10 f32 operations a pixel: the two tile coordinates' fma, fraction
    # and weights, two blends of two terms, the column sum, the round.
    bound_ms, bound_by = bound(2 * H * W + 4 * n_lut, 10 * H * W, F32_FLOPS)
    phase("kernel", f"{share('clahe_apply', bound_ms, kernel_ms)} (held-stream CUDA events "
          f"{held * 1e3:.1f} us), plain {plain_ms * 1e3:.1f} us, bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}), no library call, on {smi}")
    records.append(dict(name="clahe_apply", route="cuda",
                        source="chessboard_vision_tpu_torch/kernels/clahe.cu",
                        replaces="chessboard_vision_tpu/ops/pallas/clahe_apply.py:264",
                        max_abs_err=0, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=None))
    return records


BATCH_BOARDS = (1, 8)  # boards a launch: one stream, and an 8-stream tick


def batched_enhancement_phase(pipe, camera, smi):
    """B2-B4 with a board axis at the enhanced path's 980^2 boards: 8
    distinct renders of the start position warped by gather (one call for
    the 8 frames), lit as the path lights them (B2's input) and their Lab-L
    (B3's and B4's). At N = 1 and 8, and on a mixed batch (a rendered
    board, random u8, a constant board), each kernel is ONE launch for the
    N boards, bit-equal to its plain version on the batch and to N
    single-board launches. Then each kernel's device time a launch at N = 1
    and 8 (kernel_vs_plain_ms: plain, kernel, kernel, plain) and a board,
    beside N times the single-board launch, the plain version's time and
    the bound at N boards (N times the per-board bound)."""
    tiles = 8
    frames = np.stack([camera.render(initial_occupancy(), np.random.default_rng(60 + i))
                       for i in range(max(BATCH_BOARDS))])
    boards = warp_ops.frame_to_board(on_card(frames), pipe.consts.dg).movedim(-1, -3)
    lit = correct_lighting(boards)  # (8, 3, B, B)
    lab_l = planar_bgr2lab(boards)[:, 0].contiguous()  # (8, B, B), as correct_lighting hands it
    _, C, H, W = lit.shape
    th, tw = -(-H // tiles), -(-W // tiles)
    clip = max(int(3.0 * th * tw / 256), 1)
    n_lut = tiles * tiles * 256
    g = torch.Generator(device=DEVICE).manual_seed(3)
    rand = torch.randint(0, 256, (C, H, W), device=DEVICE, generator=g, dtype=torch.uint8)
    mixed = torch.stack([lit[0], rand, torch.full_like(rand, 77)])

    def one_launch(wrapper, call, what):
        before = wrapper.launches
        out = call()
        check(wrapper.launches == before + 1,
              f"{what}: {wrapper.launches - before} launches, want 1")
        return out

    for label, x in [(f"N={n}", lit[:n]) for n in BATCH_BOARDS] + [("mixed N=3", mixed)]:
        got = one_launch(kb.bilateral_planar, lambda: kb.bilateral_planar(x),
                         f"bilateral {label}")
        check(torch.equal(got, kb.bilateral_reference(x)),
              f"bilateral {label}: the batched launch differs from plain")
        check(torch.equal(got, torch.stack([kb.bilateral_planar(b) for b in x])),
              f"bilateral {label}: the batched launch differs from single-board launches")
        lab = (planar_bgr2lab(x)[:, 0].contiguous() if label.startswith("mixed")
               else lab_l[:len(x)])
        hist, luts = one_launch(kc.clahe_hist_luts,
                                lambda: kc.clahe_hist_luts(lab, th, tw, tiles, clip),
                                f"clahe_hist_luts {label}")
        want = kc.clahe_hist_luts_reference(lab, th, tw, tiles, clip)
        singles = [kc.clahe_hist_luts(b, th, tw, tiles, clip) for b in lab]
        for i, what in enumerate(("histograms", "LUTs")):
            check(torch.equal((hist, luts)[i], want[i]),
                  f"clahe_hist_luts {label}: batched {what} differ from plain")
            check(torch.equal((hist, luts)[i], torch.stack([s[i] for s in singles])),
                  f"clahe_hist_luts {label}: batched {what} differ from single-board launches")
        out = one_launch(kc.clahe_apply, lambda: kc.clahe_apply(lab, luts, th, tw, tiles),
                         f"clahe_apply {label}")
        check(torch.equal(out, kc.clahe_apply_reference(lab, luts, th, tw, tiles)),
              f"clahe_apply {label}: the batched launch differs from plain")
        check(torch.equal(out, torch.stack([kc.clahe_apply(b, t, th, tw, tiles)
                                            for b, t in zip(lab, luts)])),
              f"clahe_apply {label}: the batched launch differs from single-board launches")
    torch.cuda.synchronize()
    phase("batched", f"B2, B3 (histograms + LUTs) and B4 on {C}x{H}x{W} boards, N = "
          f"{', '.join(map(str, BATCH_BOARDS))} rendered and a mixed N = 3 (rendered, random "
          f"u8, constant): one launch each for the N boards, bit-equal to the plain version and "
          f"to N single-board launches")

    luts8 = kc.clahe_hist_luts(lab_l, th, tw, tiles, clip)[1]
    rows = (  # name, kernel(n), plain(n), iters, per-board (bytes, operations)
        ("bilateral", lambda n: kb.bilateral_planar(lit[:n]),
         lambda n: kb.bilateral_reference(lit[:n]), 10,
         (2 * C * H * W, BILATERAL_TAPS * BILATERAL_FLOPS_PER_TAP * H * W)),
        ("clahe_hist_luts", lambda n: kc.clahe_hist_luts(lab_l[:n], th, tw, tiles, clip),
         lambda n: kc.clahe_hist_luts_reference(lab_l[:n], th, tw, tiles, clip), 50,
         (H * W + 8 * n_lut, th * tiles * tw * tiles)),
        ("clahe_apply", lambda n: kc.clahe_apply(lab_l[:n], luts8[:n], th, tw, tiles),
         lambda n: kc.clahe_apply_reference(lab_l[:n], luts8[:n], th, tw, tiles), 50,
         (2 * H * W + 4 * n_lut, 10 * H * W)),
    )
    for name, kernel, plain, iters, (nbytes, flops) in rows:
        one = None
        for n in BATCH_BOARDS:
            ms, plain_ms, held = kernel_vs_plain_ms(functools.partial(kernel, n),
                                                    functools.partial(plain, n), iters)
            one = ms if one is None else one
            b, by = bound(n * nbytes, n * flops, F32_FLOPS)
            phase("batched", f"{name} N={n}: {ms * 1e3:.2f} us a launch (held-stream CUDA "
                  f"events {held * 1e3:.2f}), {ms / n * 1e3:.2f} us a board; {n} x the "
                  f"single-board launch {n * one * 1e3:.2f} us ({n * one / ms:.2f}x); plain "
                  f"{plain_ms * 1e3:.1f} us; bound at N={n} {b * 1e3:.2f} us ({by}), "
                  f"{b / ms:.0%} of it; on {smi}")


# Each kernel of the port by the name of its records: (B#, its stage).
KERNEL_STAGE = {"score_matmul_kernel": ("B1", "hough"), "bilateral_kernel": ("B2", "enhance"),
                "clahe_hist_tile_kernel": ("B3", "enhance"),
                "clahe_apply_kernel": ("B4", "enhance")}
STAGE_STEPS, STAGE_TICKS = 20, 10
B4_WINDOWS = 10
OTHER_SHARE = 0.10  # "other" (no mapped frame, or no launch in the trace) stays under it


def trace_window(body, iters, log_dir):
    """device_trace (Python stacks on) over PAD_LAUNCHES sleep kernels and
    then iters calls of body() (after a warmup), with CUDA events recorded
    after the pads and after the calls: (the trace's events, the profiler,
    the events' ms)."""
    for _ in range(3):
        body()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with device_trace(log_dir) as prof:
        sleep_pads()
        start.record()
        for _ in range(iters):
            body()
        end.record()
        torch.cuda.synchronize()
    return load_trace(log_dir), prof, start.elapsed_time(end)


def record_counts(events, prof):
    """Queue C 15's counts of a window that starts with the pads: (a) the
    runtime's launch and copy calls on the host, in the trace and in
    key_averages; (b) the trace's device records; (c) the device events of
    prof.events() and of key_averages; the positions of the launches whose
    record (by correlation) is missing; and the trace's span from the first
    to the last record of a launch after the pads, in ms."""
    from torch.autograd import DeviceType

    calls = sorted((e for e in events if e.get("ph") == "X"
                    and e.get("cat") in LAUNCH_CATEGORIES and e.get("name") in LAUNCH_CALLS),
                   key=lambda e: e["ts"])
    records = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    by_corr = {e["args"].get("correlation"): e for e in records}
    own = [by_corr[c["args"]["correlation"]] for c in calls[PAD_LAUNCHES:]
           if c["args"]["correlation"] in by_corr]
    averages = prof.key_averages()
    return dict(
        a_trace=len(calls),
        a_averages=sum(e.count for e in averages
                       if e.device_type == DeviceType.CPU and e.key in LAUNCH_CALLS),
        b_trace=len(records),
        c_events=sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA),
        c_averages=sum(e.count for e in averages if e.device_type == DeviceType.CUDA),
        lost=[i for i, c in enumerate(calls) if c["args"]["correlation"] not in by_corr],
        span_ms=(max(e["ts"] + e["dur"] for e in own) - min(e["ts"] for e in own)) / 1e3
        if own else 0.0)


def counts_agree(c):
    """The launch calls agree between the trace and key_averages, and the
    trace's device records with prof.events() and key_averages."""
    return c["a_trace"] == c["a_averages"] and c["b_trace"] == c["c_events"] == c["c_averages"]


def counts_text(c, event_ms):
    """record_counts for a line."""
    lost = c["lost"]
    own = sum(i >= PAD_LAUNCHES for i in lost)
    where = ("none" if not lost else
             f"the window's first {len(lost)}" if lost == list(range(len(lost))) else
             f"at positions {lost[:8]}")
    return (f"(a) {c['a_trace']} launch and copy calls in the trace, {c['a_averages']} in "
            f"key_averages; (b) {c['b_trace']} device records in the trace; (c) "
            f"{c['c_events']} device events in prof.events(), {c['c_averages']} in key_averages; "
            f"launches without a record: {where} ({len(lost) - own} of the {PAD_LAUNCHES} pads, "
            f"{own} of the window's own); the trace's span of the window's own records "
            f"{c['span_ms']:.3f} ms against CUDA events {event_ms:.3f} ms")


def stages_phase(pipe, frame, camera, g, smi):
    """Queue C 15's counts in a window of 100 B4 calls, then the per-stage
    device time (utils.profiling.aggregate_device_op_ms over a device_trace
    with STAGE_OF) of 20 plain steps, 20 enhanced steps and 10 ticks of 8
    plain streams at 1080p on HWC host frames, each in one window that
    starts with the pads: the stages sum to the trace's device total, each
    kernel's records land in its stage, "other" stays under OTHER_SHARE;
    each window's total beside step_busy's for the same call."""
    from torch.autograd import DeviceType

    lab_l = planar_bgr2lab(lit_board(pipe, frame))[0]
    tiles = 8
    th, tw = -(-lab_l.shape[0] // tiles), -(-lab_l.shape[1] // tiles)
    _, lut = kc.clahe_hist_luts(lab_l, th, tw, tiles, max(int(3.0 * th * tw / 256), 1))

    def b4():
        kc.clahe_apply(lab_l, lut, th, tw, tiles)

    rng = np.random.default_rng(13)
    frames = [camera.render(initial_occupancy(), rng) for _ in range(4)]

    def stepper(p):
        # One-frame step_many calls run eagerly, so each record keeps the
        # frames that launched it (a graphed step's all come from its replay).
        state, i = [p.capture_reference(p.init_state(), frames[0])], itertools.count()

        def step():
            state[0], _ = p.step_many(state[0], frames[next(i) % 4][None],
                                      squares_to_check=ALL_SQUARES)
        return step

    ms8 = tms.MultiStreamPipeline(g, 8, device=DEVICE)
    k8 = np.stack([frames[s % 4] for s in range(8)])
    ticks = [ms8.capture_reference(ms8.init_state(), k8)]

    def tick():
        ticks[0], _ = ms8.step(ticks[0], k8)

    windows = (("plain step", stepper(tp.VisionPipeline(g, device=DEVICE)), STAGE_STEPS,
                {"B1": 1}),
               ("enhanced step", stepper(tp.VisionPipeline(g, device=DEVICE, with_enhancer=True)),
                STAGE_STEPS, {"B1": 1, "B2": 1, "B3": 1, "B4": 1}),
               ("8-stream tick", tick, STAGE_TICKS, {"B1": 1}))
    with tempfile.TemporaryDirectory(prefix="stages_") as tdir:
        lost, prefix, agree = [], True, True
        for k in range(B4_WINDOWS):
            events, prof, event_ms = trace_window(b4, 100, os.path.join(tdir, "b4"))
            counts = record_counts(events, prof)
            lost.append(len(counts["lost"]))
            prefix &= counts["lost"] == list(range(len(counts["lost"])))
            agree &= counts_agree(counts)
            if k:
                continue
            name = next(k for k in (e.get("name", "") for e in events) if "clahe_apply_kernel" in k)
            trace_us = np.median([e["dur"] for e in events if e.get("name") == name
                                  and e.get("cat") in DEVICE_CATEGORIES])
            events_us = np.median([e.device_time_total for e in prof.events()
                                   if e.device_type == DeviceType.CUDA and e.name == name])
            held = held_ms(b4, 100)
            phase("profiler", f"100 B4 calls (Queue C 15): {counts_text(counts, event_ms)}; "
                  f"B4's median record {trace_us:.3f} us in the trace, {events_us:.3f} us in "
                  f"prof.events(), held-stream CUDA events {held * 1e3:.3f} us; on {smi}")
        phase("profiler", f"{B4_WINDOWS} windows of 100 B4 calls, each after the {PAD_LAUNCHES} "
              f"pads: (a) and (b) = (c) agree in every window: {agree}; launches without a "
              f"record {lost}; each the window's first launches: {prefix}; all within the "
              f"pads: {max(lost) <= PAD_LAUNCHES}")
        for label, body, n, want in windows:
            log_dir = os.path.join(tdir, label.split()[0])
            events, prof, event_ms = trace_window(body, n, log_dir)
            counts = record_counts(events, prof)
            if label == "plain step":
                phase("profiler", f"{n} plain {WIDTH}x{HEIGHT} steps (Queue C 15): "
                      f"{counts_text(counts, event_ms)}; on {smi}")
            total = sum(e["dur"] for e in events if e.get("ph") == "X"
                        and e.get("cat") in DEVICE_CATEGORIES) / 1e3 / n
            stages = aggregate_device_op_ms(log_dir, stage_of=STAGE_OF, per=n)
            check(abs(sum(stages.values()) - total) <= 1e-3 * total,
                  f"stages {label}: the stages sum to {sum(stages.values()):.4f} ms, the trace's "
                  f"device total is {total:.4f} ms")
            check(stages.get("other", 0.0) < OTHER_SHARE * total,
                  f"stages {label}: other {stages.get('other', 0.0):.4f} of {total:.4f} ms")
            found = collections.Counter()
            for kernel_name, frames_, _ in device_op_rows(log_dir):
                for key, (b, stage) in KERNEL_STAGE.items():
                    if key in kernel_name:
                        got = stage_of_frames(frames_, STAGE_OF)
                        check(got == stage, f"stages {label}: a {b} record landed in {got}, "
                              f"not {stage} (frames {frames_})")
                        found[b] += 1
            whole = not any(i >= PAD_LAUNCHES for i in counts["lost"])
            for b in ("B1", "B2", "B3", "B4"):
                n_want = n * want.get(b, 0)
                check(found[b] == n_want if whole else found[b] <= n_want,
                      f"stages {label}: {found[b]} {b} records, want {n_want}")
            busy, ops, note = step_busy(body, 5)
            table = ", ".join(f"{k} {v:.4f} ({v / total:.1%})" for k, v in stages.items())
            kernels = ", ".join(f"{b} {found[b]}" for b in ("B1", "B2", "B3", "B4") if found[b])
            phase("stages", f"{label}, {n} in one window, {WIDTH}x{HEIGHT} HWC host frames: "
                  f"device {total:.4f} ms a {label.split()[-1]} by the trace (step_busy "
                  f"{busy:.4f} ms, {note}); {table}; records: {kernels} in their stages; "
                  f"{counts['a_trace']} launches, {counts['b_trace']} records in the trace, "
                  f"{counts['c_events']} device events, (a) and (b) = (c) agree: "
                  f"{counts_agree(counts)}, {len(counts['lost'])} missing "
                  f"({sum(i >= PAD_LAUNCHES for i in counts['lost'])} after the pads); on {smi}")


# The bench's phase: its arguments (a short run, ~90 s at 1080p), the keys
# of its line, and how far a per-stage table's total may lie from
# step_busy's device time of the same steps.
BENCH_ARGV = ("--frames", "128", "--passes", "2")
BENCH_KEYS = ("chunk", "frames", "device", "build_s", "first_step_s", "pass_median_fps",
              "distinct_frames_fps", "host_frames_fps", "per_stage_ms", "per_stage_window",
              "strict_sync_p50_ms", "batched_streams", "batched_aggregate_fps",
              "batched_host_frames_fps", "batched_distinct_fps", "batched_16stream_fps",
              "peak_mem_gb", "enhanced_fps", "per_stage_ms_enhanced",
              "batched_enhanced_fps", "batched_enhanced_distinct_fps")
BENCH_STAGE_SHARE = 0.03


def bench_phase(smi):
    """tools/bench.py's main in this process at a short length, with every
    count set to 0 just before it and read just after: every key of its
    line, every fps > 0, every FEN's board the synthetic frame's
    occupancy, the 8-stream rig's first chunk on device-resident buffers
    equal tick for tick to the same chunk as host arrays (and to the
    truth), each per-stage table's total within BENCH_STAGE_SHARE of
    step_busy's device time of the same steps, and B1-B4 launched.
    Returns the launch counts."""
    t0 = time.perf_counter()
    with counted(collections.Counter()) as got:
        report = bench.main(list(BENCH_ARGV))
    seconds = time.perf_counter() - t0
    line, extras = report.line, report.line["extras"]
    missing = [k for k in BENCH_KEYS if k not in extras]
    check(not missing and line["metric"] == "fps_1080p_frame_to_fen",
          f"bench: keys missing from its line: {missing}")
    fps = dict(value=line["value"], **{k: v for k, v in extras.items()
                                       if k.endswith("_fps") and k != "pass_median_fps"},
               **{f"pass_median {k}": v for k, v in extras["pass_median_fps"].items()})
    check(all(v > 0 for v in fps.values()), f"bench: an fps <= 0 in {fps}")
    truth = occupancy_to_fen(bench.OCCUPANCY).split()[0]
    for label, fens in report.fens.items():
        boards = collections.Counter(f.split()[0] for f in fens)
        check(set(boards) == {truth}, f"bench {label}: boards {dict(boards)}, want {truth}")
    n, t = extras["batched_streams"], extras["chunk"]
    on_card = report.first_chunks[f"{n}-stream (chunk {t})"]
    on_host = report.first_chunks[f"{n}-stream host frames (chunk {t})"]
    want = torch.as_tensor(bench.OCCUPANCY.T.reshape(64)).expand(on_card.shape)
    check(on_card.shape == (t, n, 64) and torch.equal(on_card, on_host),
          f"bench: the {n}-stream rig's occupancy on device-resident buffers differs from "
          "the same frames as host arrays")
    check(torch.equal(on_card, want), f"bench: the {n}-stream rig's occupancy is not the truth")
    busy_text = []
    for label, (step, steps) in report.windows.items():
        stages = extras["per_stage_ms" if label == "plain" else "per_stage_ms_enhanced"]
        total = sum(stages.values())
        busy = step_busy(step, 5)[0]
        check(abs(total - busy) <= BENCH_STAGE_SHARE * busy,
              f"bench {label}: the per-stage table sums to {total:.4f} ms a step, step_busy "
              f"reads {busy:.4f}")
        busy_text.append(f"{label} {total:.4f} ms a step by the table, {busy:.4f} by step_busy "
                         f"({extras['per_stage_window'][label]})")
    missing = [k for k in COUNTERS if k != "clahe_hist" and got[k] == 0]
    check(not missing, f"the bench never launched {missing}")
    check(got["clahe_hist"] == 0, "the bench launched the histogram-only B3")
    phase("bench", f"{' '.join(BENCH_ARGV)} in {seconds:.1f} s: {line['value']} fps headline; "
          f"every FEN {truth}; the {n}-stream rig's first chunk on the card equal to host "
          f"frames on all {t} ticks; {'; '.join(busy_text)}; launches {got}; on {smi}")
    return got


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


# Every kernel's launch counter, which the path checks read. The resample
# kernel (port-only) launches once a step where a planar frame (a host
# array is taken planar) or a per-rig tick is resampled, and not where HWC
# frames on the card or a shared-geometry tick's take the gather warp; the
# checks that no enhancement kernel launched leave it out (ENHANCEMENT).
COUNTERS = launch_counters()
ENHANCEMENT = ("bilateral", "clahe_hist", "clahe_hist_luts", "clahe_apply")
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


def check_tick(got, n, label, enhanced=False, resample=0):
    """One tick of n streams: B1 once, on the TMA kernel with n*64 columns;
    B2, B3 (through clahe_hist_luts) and B4 once when enhanced (one launch
    for the n boards), else not at all; the resample kernel ``resample``
    times (1 on per-rig plans: every board in one launch; 0 where the
    shared geometry warps HWC host frames by gather)."""
    k = 1 if enhanced else 0
    want = {"score_matmul": 1, "bilateral": k, "clahe_hist": 0, "clahe_hist_luts": k,
            "clahe_apply": k, "resample": resample}
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
    check(not any(got[k] for k in COUNTERS if k != "resample")
          and got["resample"] >= EXACT_FRAMES + 2,
          f"the exact path launched kernels other than the resample, or resampled fewer "
          f"than its {EXACT_FRAMES + 2} planar frames: {got}")
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
        busy = step_busy(lambda: p.step(st, next(it), squares_to_check=s2c), 2)
        lines.append(f"{name} {ms[name]:.3f} ms/frame, {busy_text(*busy, ms[name], '')}, "
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
    two launches bit-equal, scores within tolerance of the plain version,
    the masked first-max argmax equal on every square; device time (and
    held-stream CUDA-event time) beside the library call's and the bound."""
    (M, K), max_err = basis.shape, 0.0
    for n in (8, 16):
        pf = planes[: n * 64]
        got = sm.score_matmul(basis, pf)
        check(sm.score_matmul.last_path == "tma",
              f"score_matmul N={n * 64}: took the {sm.score_matmul.last_path} kernel")
        check(torch.equal(got, sm.score_matmul(basis, pf)),
              f"score_matmul N={n * 64}: two launches differ")
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
        bound_ms, bound_by = b1_bound(M, n * 64, K)
        kernel_ms, library_ms, held = kernel_vs_plain_ms(
            lambda: sm.score_matmul(basis, pf), library[1], 100)
        plain_ms = device_ms(lambda: sm.score_matmul_reference(basis, pf), 100)
        library_held = held_ms(library[1], 100)
        wg, nt = sm.tile_shape(M, n * 64, torch.cuda.get_device_properties(0)
                               .multi_processor_count)
        phase("streams", f"score_matmul N={n * 64} ({n} streams): ({M}, {K}) x ({n * 64}, {K}) "
              f"on the tma kernel ({64 * wg} x {64 * nt} CTA tiles), each stream's columns "
              f"bit-equal to its N=64 launch, two launches bit-equal, "
              f"max_abs_err {err!r}, argmax equal on all {n * 64} squares; device "
              f"{kernel_ms * 1e3:.1f} us/call (held-stream CUDA events {held * 1e3:.1f} us, "
              f"{library[0]} {library_held * 1e3:.1f} us), plain "
              f"(cuBLAS f32) {plain_ms * 1e3:.1f} us, {library[0]} {library_ms * 1e3:.1f} us, "
              f"bound {bound_ms * 1e3:.1f} us "
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

    busy = step_busy(tick, 5)
    phase("streams", f"{label}: {wall_ms:.3f} ms/tick ({n * 1e3 / wall_ms:.1f} frames/s "
          f"aggregate; host pack+upload {pack_ms:.3f} ms, step enqueue incl. pack "
          f"{enqueue_ms:.3f} ms), {busy_text(*busy, wall_ms, '/tick')}, peak memory "
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
        check_tick(got, 2, f"{kind} per-stream geometry", enhanced, resample=1)
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
    return counts, b1_err, (sets, initial, occs)


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


MESH_STREAMS = 8
MESH_TICKS = 3
FLEET_TIMEOUT_S = 120
FLEET_SLOTS = 2  # slots a fleet process: 2 of its 4 streams a slot


def check_mesh_tick(got, ms, label, enhanced=False):
    """One tick of a meshed pipeline: B1 once a slot, on the TMA kernel at
    the slot's width (its streams times its squares); B2, B3 (through
    clahe_hist_luts) and B4 once a slot when enhanced (one launch for the
    slot's boards), else not at all; the resample kernel once a slot on
    per-rig plans, else not at all (the mesh's ticks are HWC host frames,
    which the shared geometry warps by gather)."""
    slots = len(ms.slots)
    k = slots if enhanced else 0
    want = {"score_matmul": slots, "bilateral": k, "clahe_hist": 0, "clahe_hist_luts": k,
            "clahe_apply": k, "resample": slots if ms._stream_plans is not None else 0}
    check(got == want, f"{label}: launches in one tick {got}, want {want}")
    width = len(ms.slots[0].block.streams) * len(ms.slots[0].block.squares)
    path, shape = sm.score_matmul.last_path, sm.score_matmul.last_shape
    check(path == "tma" and shape[1] == width,
          f"{label}: B1 took the {path} kernel at (M, N, K) {shape}, want N = {width} on tma")


def mesh_vs_unsharded(meshed, unsharded, singles, refs, ticks, label, launches, enhanced=False):
    """Capture and MESH_TICKS ticks of (frames, masks) through the meshed
    pipeline (counted), the unsharded pipeline and one single-stream
    pipeline a stream (``singles[s]``, fed ``single_frames(frames, s)``):
    every stream's outputs equal to both (bool/i32 exactly, f32 within the
    CPU tests' tolerance; the FSM outputs exactly). Returns the meshed host
    outputs of the last tick and its state."""
    n = meshed.n_streams
    with counted(launches):
        state = meshed.capture_reference(meshed.init_state(), refs)
    ref_state = unsharded.capture_reference(unsharded.init_state(), refs)
    single_states = [pipe.capture_reference(pipe.init_state(), feed(refs[s]))
                     for s, (pipe, feed) in enumerate(singles)]
    for t, (frames, masks) in enumerate(ticks):
        with counted(launches) as got:
            state, out = meshed.step(state, frames, s2c_masks=masks)
        check_mesh_tick(got, meshed, f"{label} tick {t}", enhanced)
        host = tms.outputs_to_numpy(out)
        check(host.step.occupancy.shape == (n, 64) and host.noise.mode.shape == (n,)
              and out.streams == range(n) and out.step.occupancy.device == meshed.device,
              f"{label}: outputs {host.step.occupancy.shape} on {out.step.occupancy.device}")
        ref_state, ref = unsharded.step(ref_state, frames, s2c_masks=masks)
        ref = tms.outputs_to_numpy(ref)
        for s in range(n):
            _compare_outputs(_stream_outputs(host, s), _stream_outputs(ref, s),
                             f"{label} tick {t} stream {s} vs unsharded")
            pipe, feed = singles[s]
            single_states[s], o = pipe.step(single_states[s], feed(frames[s]),
                                            squares_to_check=tp.occupancy_to_set(masks[s]))
            _compare_outputs(_stream_outputs(host, s), tp.outputs_to_numpy(o),
                             f"{label} tick {t} stream {s} vs single-stream")
        for f in host.noise._fields:
            check(np.array_equal(getattr(host.noise, f), getattr(ref.noise, f)),
                  f"{label} tick {t}: noise {f} differs from the unsharded pipeline")
    return host, state


def mesh_tick_ms(ms, state, frame_sets, masks, ticks=TIMED_TICKS):
    """ms a tick of chained ticks (host clock, the card synchronized at
    both ends), and the state."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(ticks):
        state, _ = ms.step(state, frame_sets[t % len(frame_sets)], s2c_masks=masks)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / ticks, state


def mesh_phase(corners, g, frames, smi):
    """The stream mesh (parallel/mesh.py) at 1080p on MESH_STREAMS streams,
    each showing its own first move (stream 0: e2e4), on slots spread over
    the cards (one card: cuda:0 eight times): dp 8, dp x sp 4 x 2,
    per-stream geometry (odd rigs' corners shifted) on dp 8, and enhanced
    on dp 8 and (one tick) on dp x sp 4 x 2, each against the unsharded pipeline and one single-stream
    pipeline a stream, with the launch counts set to 0 just before each
    meshed call and read just after it; then ms a tick of unsharded, dp 8
    and 4 x 2 in turns. Returns the path's counts."""
    sets, initial, occs = frames
    n = MESH_STREAMS
    cards = torch.cuda.device_count()
    slots = [f"cuda:{i % cards}" for i in range(n)]
    phase("mesh", f"{cards} card(s); slots {slots}")
    dp = make_mesh(n, devices=slots)
    dpsp = make_mesh(n, ("data", "space"), (n // 2, 2), devices=slots)
    refs = np.stack([initial[s % 3] for s in range(n)])
    masks = [np.stack([positions_to_mask(_occ_set(o)) for o in occs[:n]]), _all_masks(n)]
    ticks = [(np.stack(sets[t % 2][:n]), masks[t % 2]) for t in range(MESH_TICKS)]
    launches = collections.Counter()
    single = tp.VisionPipeline(g, device=DEVICE)
    hwc = [(single, on_card)] * n  # the tick warps HWC host frames by gather, as the singles do
    unsharded = tms.MultiStreamPipeline(g, n, device=DEVICE)
    meshed = {}
    for label, mesh in (("dp 8", dp), ("dp x sp 4x2", dpsp)):
        ms = tms.MultiStreamPipeline(g, n, mesh=mesh)
        check(len({id(s.pipe) for s in ms.slots}) == len(set(slots)),
              f"{label}: one base pipeline a distinct device")
        host, state = mesh_vs_unsharded(ms, unsharded, hwc, refs, ticks, label, launches)
        for s in range(n):
            check(tp.occupancy_to_set(host.step.occupancy[s]) == _occ_set(occs[s]),
                  f"{label}: stream {s} occupancy != rendered truth")
        meshed[label] = (ms, state)
        phase("mesh", f"{label} ({mesh.shape}): capture + {MESH_TICKS} ticks equal the "
              f"unsharded pipeline and {n} single-stream pipelines on every stream; every "
              f"stream's occupancy equals its rendered truth; B1 {len(ms.slots)} launches a "
              f"tick on the tma kernel at N = {sm.score_matmul.last_shape[1]}")

    corners2 = corners + np.array([[14, 9], [-11, 6], [8, -7], [-12, -10]])
    g2 = BoardGeometry.from_calibration(corners2, display_size=(WIDTH, HEIGHT))
    camera2 = SynthCamera(corners2, frame_size=(HEIGHT, WIDTH), board_px=g2.board_size)
    odd = list(range(1, n, 2))
    shifted = [render_all(camera2, [occs[s] for s in odd], seed) for seed in (14, 15)]
    ref2 = camera2.render(initial_occupancy(), np.random.default_rng(16))
    geos = [g2 if s % 2 else g for s in range(n)]
    refs2, ticks2 = refs.copy(), []
    refs2[odd] = ref2
    for frames_t, m in ticks:
        frames_t = frames_t.copy()
        frames_t[odd] = shifted[len(ticks2) % 2]
        ticks2.append((frames_t, m))
    pipes = {id(geo): tp.VisionPipeline(geo, device=DEVICE) for geo in (g, g2)}
    # Per-stream plans resample planar frames: the singles are given the same.
    planar = [(pipes[id(geos[s])], to_planar) for s in range(n)]
    ms = tms.MultiStreamPipeline(geos, n, mesh=dp)
    host, _ = mesh_vs_unsharded(ms, tms.MultiStreamPipeline(geos, n, device=DEVICE), planar,
                                refs2, ticks2, "per-stream geometry dp 8", launches)
    for s in range(n):
        check(tp.occupancy_to_set(host.step.occupancy[s]) == _occ_set(occs[s]),
              f"per-stream geometry dp 8: stream {s} occupancy != rendered truth")
    phase("mesh", f"per-stream geometry dp 8 ({n} rigs, the odd ones' corners shifted): equal "
          f"to the unsharded per-stream pipeline and {n} single-stream pipelines of their "
          "rigs; every stream's occupancy equals its rendered truth")
    del ms, planar, pipes

    enhanced = tp.VisionPipeline(g, with_enhancer=True, device=DEVICE)
    ms = tms.MultiStreamPipeline(g, n, mesh=dp, with_enhancer=True)
    mesh_vs_unsharded(ms, tms.MultiStreamPipeline(g, n, with_enhancer=True, device=DEVICE),
                      [(enhanced, on_card)] * n, refs, ticks, "enhanced dp 8", launches,
                      enhanced=True)
    phase("mesh", f"enhanced dp 8: equal to the unsharded enhanced pipeline and {n} "
          "single-stream enhanced pipelines; B2, B3 and B4 once a slot a tick")
    ms = tms.MultiStreamPipeline(g, n, mesh=dpsp, with_enhancer=True)
    mesh_vs_unsharded(ms, tms.MultiStreamPipeline(g, n, with_enhancer=True, device=DEVICE),
                      [(enhanced, on_card)] * n, refs, ticks[:1], "enhanced dp x sp 4x2",
                      launches, enhanced=True)
    phase("mesh", f"enhanced dp x sp 4x2 ({len(ms.slots[0].block.streams)} streams a slot): "
          f"equal to the unsharded enhanced pipeline and {n} single-stream enhanced "
          f"pipelines; B2, B3 and B4 once a slot a tick ({len(ms.slots)}), each launch "
          "for the slot's boards, not once a stream and slot")
    del ms, enhanced

    frame_sets = [np.stack(fs[:n]) for fs in sets]
    state = unsharded.capture_reference(unsharded.init_state(), refs)
    timed = {"unsharded": (unsharded, state), **meshed}
    ms_tick = collections.defaultdict(list)

    def meshed_counted(label):  # the unsharded pipeline's launches are not the mesh path's
        return contextlib.nullcontext() if label == "unsharded" else counted(launches)

    for label in ("unsharded", "dp 8", "dp x sp 4x2", "dp x sp 4x2", "dp 8", "unsharded"):
        pipe, st = timed[label]
        with meshed_counted(label):
            wall, st = mesh_tick_ms(pipe, st, frame_sets, masks[1])
        timed[label] = (pipe, st)
        ms_tick[label].append(wall)
    for label, (pipe, st) in timed.items():
        box = [st]

        def tick():
            box[0], _ = pipe.step(box[0], frame_sets[0], s2c_masks=masks[1])

        with meshed_counted(label):
            busy = step_busy(tick, 3)
        wall = np.mean(ms_tick[label])
        phase("mesh", f"{label}: {wall:.3f} ms/tick "
              f"({', '.join(f'{w:.3f}' for w in ms_tick[label])} in turns; "
              f"{n * 1e3 / wall:.1f} frames/s), {busy_text(*busy, wall, '/tick')}; on {smi}. "
              "On one card this is the host cost of sharding (each slot enqueues its own tick), "
              "not a scaling figure")
    counts = {name: launches[name] for name in COUNTERS}
    phase("mesh", f"kernel launches on this path: {counts}")
    return counts


def fleet_launch(frames_path, expected_path, devices, backend, label):
    """One fleet worker process a device of ``devices`` on a free port, each
    waited for FLEET_TIMEOUT_S and killed past it; every rank must exit 0
    and print FLEET-OK. Returns the wall seconds from launch to the last
    exit."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.dirname(os.path.abspath(__file__)), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "chessboard_vision_tpu_torch.tools.dryrun_multigpu",
         "--fleet-worker", str(rank), str(len(devices)), str(port), frames_path, expected_path,
         "--device", dev, "--backend", backend],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank, dev in enumerate(devices)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=FLEET_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, out) in enumerate(zip(procs, outs)):
        line = next((ln for ln in out.splitlines() if ln.startswith(f"FLEET-OK rank={rank}")), None)
        check(p.returncode == 0 and line, f"{label}: rank {rank} rc {p.returncode}:\n{out[-3000:]}")
        phase("fleet", line)
    return wall


def fleet_phase(smi):
    """A two-process fleet of the port (parallel/distributed.py) over Gloo,
    both processes on cuda:0, 4 streams of 1280x720 each (the live
    driver's capture) on FLEET_SLOTS slots each, every rank's occupancy
    held to its rows of this process's unsharded run; then a one-process
    NCCL group on the card whose all_reduce of the streams' occupancy
    counts (fleet_sum) must equal their sum."""
    g, camera = dryrun_multigpu.rig((720, 1280), margin=100)
    refs, steps = dryrun_multigpu.stream_frames(camera, 8, seed=20)
    ms = tms.MultiStreamPipeline(g, 8, device=DEVICE)
    state = ms.capture_reference(ms.init_state(), refs)
    state, out = ms.step(state, steps)
    occ = tms.outputs_to_numpy(out).step.occupancy
    with tempfile.TemporaryDirectory() as tmp:
        frames_path, expected_path = os.path.join(tmp, "fleet.npz"), os.path.join(tmp, "exp.npz")
        dryrun_multigpu.save_fleet(frames_path, refs, steps, g, 100, FLEET_SLOTS)
        np.savez(expected_path, occ=occ)
        wall = fleet_launch(frames_path, expected_path, ["cuda:0", "cuda:0"], "gloo", "gloo fleet")
        phase("fleet", f"gloo fleet: 2 processes on cuda:0, 8 streams of 1280x720, each rank's "
              f"occupancy equal to its rows of the unsharded run; {wall:.2f} s wall from launch "
              f"to exit (process start, CUDA init, build and capture included); on {smi}")
        if torch.cuda.device_count() >= 2:
            wall = fleet_launch(frames_path, expected_path, ["cuda:0", "cuda:1"], "nccl",
                                "nccl fleet")
            phase("fleet", f"nccl fleet: 2 processes on cuda:0 and cuda:1, {wall:.2f} s wall")
        else:
            phase("fleet", "NCCL across processes not run: it needs a card a process and this "
                  f"machine has {torch.cuda.device_count()} (NCCL refuses two ranks on one card)")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    check(pdist.init_distributed(f"localhost:{port}", 1, 0, backend="nccl"),
          "nccl: init_distributed returned False")
    try:
        per_stream = out.step.occupancy.sum(dim=1)
        total = pdist.fleet_sum(per_stream)
        check(torch.distributed.get_backend() == "nccl" and int(total) == int(occ.sum()),
              f"nccl: fleet_sum {int(total)} != {int(occ.sum())}")
    finally:
        torch.distributed.destroy_process_group()
    phase("fleet", f"one-process NCCL group on the card: all_reduce of the 8 streams' occupancy "
          f"counts = {int(total)}, their sum")


# The footage phase's game: 4 start frames, then FOOTAGE_RUN frames after
# each move; the reader reports FOOTAGE_FPS. The reference is taken from
# frame 3, so processed frame i (the timeline's "frame") is rendered frame
# i + 2: e2e4 shows on processed frame 2, e7e5 on frame 30.
FOOTAGE_FPS, FOOTAGE_START, FOOTAGE_RUN = 30, 4, 28
FOOTAGE_SHOWS = (2, 30)
# Frames from a move's first frame to its commit: 20 stable frames (the
# 19 after the first), plus up to 2 while the 5-frame vote flips and 2
# while the noise gate settles.
COMMIT_LAG = range(19, 24)
# The cooldown clip: e2e4 shown for 20 frames, then e7e5 (shows on frame
# 22, ~22 frames after e2e4's commit); 2.0 s is 60 frames at 30 fps, 0.5 s
# is 15.
COOLDOWN_E2E4_FRAMES, COOLDOWN_SHOWS = 20, (2, 22)
MIDGAME_FEN = "r1bqkbnr/pppp1ppp/2n5/4p3/4P3/5N2/PPPP1PPP/RNBQKB1R w KQkq - 4 3"
# process_video --pgn's document of the game.
FOOTAGE_PGN = ('[Event "digitized recording"]\n[Site "?"]\n[Date "????.??.??"]\n[Round "?"]\n'
               '[White "?"]\n[Black "?"]\n[Result "*"]\n\n1. e4 e5 *\n')
# api.enhance_frame's shapes: the whole 1080p frame, the JAX test's crop
# and an odd crop whose width is not a multiple of 4 (top, left, h, w).
ENHANCE_CROPS = ((0, 0, 1080, 1920), (420, 800, 240, 320), (181, 321, 719, 1277))
# ROADMAP Queue C 7: the enhancement's f32 stages (Lab -> BGR, the sharpen
# of one-level differences) on two devices.
ENHANCE_MAX_DIFF, ENHANCE_FRACTION = 9, 1e-3


def typed_frames(camera, boards, seed):
    """One frame of each rules board with its piece types (per-square
    colors, per-type disc radii), each from its own seed, rendered in
    threads."""
    maps = [board_render_maps(b) for b in boards]

    def render(i):
        occ, colors, radii = maps[i]
        return camera.render(occ, np.random.default_rng((seed, i)), colors, radii)

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(render, range(len(boards))))


def _boards(*ucis):
    """The rules board after each prefix of the moves, the start first."""
    out = [rules_chess.Board()]
    for uci in ucis:
        b = rules_chess.Board(out[-1].fen())
        b.push_uci(uci)
        out.append(b)
    return out


def expected_timeline(lines, boards, shows, moves):
    """The expected JSONL lines of the commits of ``moves`` (boards[k + 1]
    the position after moves[k]) on the commit frames of the timeline
    ``lines``, each checked to lie COMMIT_LAG frames after the move shows on
    frame shows[k]. Returns (lines, commit frames)."""
    frames = [json.loads(line).get("frame") for line in lines[: len(moves)]]
    check(len(frames) == len(moves) and all(
        isinstance(f, int) and f - show in COMMIT_LAG for f, show in zip(frames, shows)),
        f"footage: commit frames {frames} for moves shown on frames {list(shows)}")
    return [json.dumps({"frame": f, "move": m, "fen": b.fen()})
            for f, m, b in zip(frames, moves, boards[1:])], frames


def timed_session():
    """A GameSession on the card with the move cooldown off (as run_capture
    builds one without a cooldown) and a 0.25 s FPS window, the call table
    emptied: its on_frame calls are timed by their ``session.on_frame``
    spans, which end after the wait for the card."""
    session = GameSession(device=DEVICE)
    session.MOVE_COOLDOWN = 0.0
    session.fps = FpsCounter(window=0.25)
    clear_calls()
    return session


def timing(session, wall_ms):
    """The footage line's times: on_frame's mean, p50 and p95 (its spans in
    the call table), the session's FPS, and the whole call with the
    session's set-up (pipeline build, reference capture)."""
    ms = np.array([c.ms("session.on_frame") for c in recorded_calls()
                   if c.root == "session.on_frame"])
    return (f"{ms.mean():.3f} ms a processed frame (on_frame mean; p50 "
            f"{np.percentile(ms, 50):.3f}, p95 {np.percentile(ms, 95):.3f} ms, its spans, "
            f"which wait for the card), session.fps {session.fps.fps:.1f}, the whole call "
            f"{wall_ms:.1f} ms with the set-up")


def footage_phase(corners, camera, smi):
    """Recorded footage through process_video.run_capture and the api on the
    card, with every count set to 0 just before each call of the path and
    read just after it. Returns the path's counts."""
    launches = collections.Counter()
    start, after1, after2 = _boards("e2e4", "e7e5")
    t0 = time.perf_counter()
    frames = typed_frames(camera, [start] * FOOTAGE_START + [after1] * FOOTAGE_RUN
                          + [after2] * FOOTAGE_RUN, 20)
    phase("footage", f"rendered {len(frames)} frames of {WIDTH}x{HEIGHT} with piece types in "
          f"{time.perf_counter() - t0:.1f} s")
    config = {"corners": np.asarray(corners).tolist(), "player_color": "white",
              "orientation_flipped": False, "display_size": [WIDTH, HEIGHT]}

    # The scripted game, plain, with the session's on_frame timed.
    session = timed_session()
    with tempfile.TemporaryDirectory() as tmp, counted(launches) as got:
        path = os.path.join(tmp, "timeline.jsonl")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moves, fen, n = process_video.run_capture(
            process_video.FrameReader(frames, FOOTAGE_FPS), config, skip_frames=1,
            out_path=path, session=session)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with open(path) as fh:
            timeline = fh.read()
    want_lines, commits = expected_timeline(timeline.splitlines(), [start, after1, after2],
                                            FOOTAGE_SHOWS, ["e2e4", "e7e5"])
    want_lines.append(json.dumps({"final_fen": after2.fen(), "moves": ["e2e4", "e7e5"],
                                  "frames": len(frames) - 3}))
    check(moves == ["e2e4", "e7e5"] and fen == after2.fen(),
          f"footage: committed {moves}, FEN {fen}, scripted e2e4 e7e5 -> {after2.fen()}")
    check(timeline == "\n".join(want_lines) + "\n",
          f"footage: the timeline differs from the expected text:\n{timeline}")
    pgn = game_to_pgn(moves, headers={"Event": "digitized recording"}, claim_draws=True)
    check(pgn == FOOTAGE_PGN, f"footage: the PGN differs from the expected text:\n{pgn}")
    want = dict.fromkeys(ENHANCEMENT, 0) | {"score_matmul": n}
    check({name: got[name] for name in want} == want and got["resample"] >= n,
          f"footage: launches {got}, want {want} (B1 once a processed frame) and the resample "
          f"at least once a processed frame")
    phase("footage", f"run_capture over {len(frames)} frames in memory ({n} processed): "
          f"committed {moves} on frames {commits}, FEN and JSONL timeline and "
          f"PGN as expected; launches {got}; {timing(session, wall_ms)}; on {smi}")

    # The frame-counted cooldown: e7e5 22 frames after e2e4.
    clip = (frames[:FOOTAGE_START + COOLDOWN_E2E4_FRAMES]
            + frames[FOOTAGE_START + FOOTAGE_RUN:])
    for seconds, want_moves in ((2.0, ["e2e4"]), (0.5, ["e2e4", "e7e5"])):
        with tempfile.TemporaryDirectory() as tmp, counted(launches):
            path = os.path.join(tmp, "timeline.jsonl")
            moves, fen, n = process_video.run_capture(
                process_video.FrameReader(clip, FOOTAGE_FPS), config, skip_frames=1,
                out_path=path, cooldown_seconds=seconds, device=DEVICE)
            with open(path) as fh:
                lines = fh.read().splitlines()
        boards = [start, after1, after2][: len(want_moves) + 1]
        want_lines, commits = expected_timeline(lines, boards, COOLDOWN_SHOWS, want_moves)
        check(moves == want_moves and lines[:-1] == want_lines and fen == boards[-1].fen(),
              f"footage cooldown {seconds} s: committed {moves}, timeline {lines}")
        phase("footage", f"cooldown_seconds={seconds} ({int(seconds * FOOTAGE_FPS)} frames at "
              f"{FOOTAGE_FPS} fps), e7e5 shown 20 frames after e2e4: committed {moves} on "
              f"frames {commits}")

    # The enhanced path through the same entry point.
    clahe, calls = tenh.clahe, [0]

    def counted_clahe(*args, **kwargs):
        calls[0] += 1
        return clahe(*args, **kwargs)

    tenh.clahe = counted_clahe
    session = timed_session()
    try:
        with counted(launches) as got:
            t0 = time.perf_counter()
            moves, fen, n = process_video.run_capture(
                process_video.FrameReader(frames, FOOTAGE_FPS), {**config, "use_enhancer": True},
                skip_frames=1, session=session)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        tenh.clahe = clahe
    check(moves == ["e2e4", "e7e5"] and fen == after2.fen(),
          f"footage enhanced: committed {moves}, FEN {fen}")
    k = calls[0]
    want = {"score_matmul": n, "bilateral": k, "clahe_hist": 0, "clahe_hist_luts": k,
            "clahe_apply": k}
    check(k == n + 1 and {name: got[name] for name in want} == want and got["resample"] >= k,
          f"footage enhanced: {k} CLAHE calls for {n} frames and the reference, launches {got}, "
          f"want {want} and a resample (the board's color warp) at least once a CLAHE call")
    phase("footage", f"enhanced run_capture: committed {moves}; {k} CLAHE calls, each one B3 "
          f"and one B4 launch; launches {got}; {timing(session, wall_ms)}; on {smi}")

    api_phase(corners, camera, frames, launches, smi)
    enhance_frame_phase(frames[0], launches, smi)
    counts = {name: launches[name] for name in COUNTERS}
    phase("footage", f"kernel launches on this path: {counts}")
    return counts


def call_ms(fn, reps=5):
    """Host-clock ms of one call of fn(), the card synchronized after each:
    the median of reps calls after one untimed call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


# The api's capture: its geometry assumes 1280x720 frames, as the JAX api's.
API_HEIGHT, API_WIDTH = 720, 1280


def api_phase(corners, camera, frames, launches, smi):
    """The api's entry points on the card, on 1280x720 frames (the capture
    the api's geometry assumes) of the benchmark's board layout: occupancy,
    FEN, changes and grid on a frame pair (start, then e2e4) with the
    default disc size, as tests/test_api.py's pair (a pawn-sized disc on a
    square of its own shade changes under 5% of the square, below the
    change model's significance: reference behaviour, ROADMAP Queue C 5);
    the full FEN on frames with piece types; ms a call of each. Then a
    GameSession's piece types and verify_position on the 1080p footage
    frames (``corners``, ``camera``)."""
    start, after1 = _boards("e2e4")
    api_corners = bench_corners(API_HEIGHT, API_WIDTH)
    api_camera = SynthCamera(api_corners, frame_size=(API_HEIGHT, API_WIDTH),
                             board_px=min(API_HEIGHT, API_WIDTH) - 100)
    rng = np.random.default_rng(33)
    f0 = api_camera.render(occupancy_of(start), rng)
    f1 = api_camera.render(occupancy_of(after1), rng)
    truth = _occ_set(occupancy_of(after1))
    with counted(launches):
        occ = api.detect_pieces(f1, api_corners, reference_frame=f0, device=DEVICE)
        fen = api.frame_to_fen(f1, api_corners, reference_frame=f0, device=DEVICE)
        changed = api.detect_changes(f1, api_corners, reference_frame=f0, device=DEVICE)
        grid = api.extract_grid(f0, api_corners, device=DEVICE)
    check(occ == truth, f"api.detect_pieces: {sorted(occ ^ truth)} differ from the truth")
    want_fen = occupancy_to_fen(occupancy_of(after1))
    check(fen == want_fen, f"api.frame_to_fen: {fen} != {want_fen}")
    check({(4, 1), (4, 3)} <= changed and len(changed) <= 8,
          f"api.detect_changes: {sorted(changed)}")
    cpu_grid = api.extract_grid(f0, api_corners, device="cpu")
    check(set(grid) == set(cpu_grid) and len(grid) == 64
          and all(grid[k].shape == cpu_grid[k].shape for k in grid),
          "api.extract_grid: crops or shapes differ from the CPU's")
    grid_diff = max(int(np.abs(grid[k].astype(int) - cpu_grid[k].astype(int)).max()) for k in grid)

    midgame = rules_chess.Board(MIDGAME_FEN)
    cal = typed_frames(api_camera, [start] * 2, 30)
    target = typed_frames(api_camera, [midgame] * 2, 31)
    with counted(launches):
        full = api.frame_to_full_fen(target[0], api_corners, cal, frames=target[1:],
                                     device=DEVICE)
    check(full.split()[0] == MIDGAME_FEN.split()[0],
          f"api.frame_to_full_fen: {full.split()[0]} != {MIDGAME_FEN.split()[0]}")
    calls = {
        "detect_pieces": lambda: api.detect_pieces(f1, api_corners, reference_frame=f0,
                                                   device=DEVICE),
        "frame_to_fen": lambda: api.frame_to_fen(f1, api_corners, reference_frame=f0,
                                                 device=DEVICE),
        "detect_changes": lambda: api.detect_changes(f1, api_corners, reference_frame=f0,
                                                     device=DEVICE),
        "extract_grid": lambda: api.extract_grid(f0, api_corners, device=DEVICE),
        "frame_to_full_fen (2 + 2 frames)": lambda: api.frame_to_full_fen(
            target[0], api_corners, cal, frames=target[1:], device=DEVICE),
    }
    ms = {name: call_ms(fn) for name, fn in calls.items()}

    more = typed_frames(camera, [start] * 3 + [after1] * 8, 32)
    session = calibrated_session(corners, (WIDTH, HEIGHT), DEVICE)
    with counted(launches):
        session.capture_reference_frame(frames[0])
        for fr in frames[1:FOOTAGE_START] + more[:3]:
            session.on_frame(fr)
        cents = session.calibrate_piece_types()
        moved = frames[FOOTAGE_START:FOOTAGE_START + FOOTAGE_RUN] + more[3:]
        commit = next((i for i, fr in enumerate(moved) if session.on_frame(fr)), None)
        check(commit is not None, "api session: e2e4 was not committed")
        for fr in moved[commit + 1: commit + 1 + session._radius_window.maxlen + 2]:
            session.on_frame(fr)
        match, got, want = session.verify_position()
    check(cents is not None and len(cents) == 12, f"api session: {cents} type centroids")
    check(match is True and want == after1.fen().split()[0],
          f"api session: verify_position {match}: {got} vs {want}")
    phase("footage", f"api on {API_WIDTH}x{API_HEIGHT}: detect_pieces and frame_to_fen equal "
          f"the truth ({fen.split()[0]}), detect_changes {sorted(changed)}, extract_grid 64 "
          f"crops of the CPU's shapes (max diff {grid_diff}), frame_to_full_fen reads "
          f"{full.split()[0]}; ms a call (median of 5, host clock, synchronized): "
          + ", ".join(f"{name} {t:.3f}" for name, t in ms.items()) + f"; on {smi}")
    phase("footage", f"a GameSession on the {WIDTH}x{HEIGHT} footage typed 12 classes, "
          f"committed e2e4 on frame {commit + 1} and verify_position matched ({got})")


def enhance_frame_phase(frame, launches, smi):
    """api.enhance_frame on the card at three shapes: B2-B4 bit-equal to
    their plain versions on the card at each, the output within Queue C 7
    of the same call on the CPU, and ms a call (the kernels' device time at
    1080x1920: whole_frame_phase)."""
    tiles = 8
    for top, left, h, w in ENHANCE_CROPS:
        crop = np.ascontiguousarray(frame[top:top + h, left:left + w])
        h, w = crop.shape[:2]
        with counted(launches) as got:
            out = api.enhance_frame(crop, device=DEVICE)
        one = dict.fromkeys(COUNTERS, 1) | {"score_matmul": 0, "clahe_hist": 0, "resample": 0}
        check(got == one, f"enhance_frame {h}x{w}: launches {got}, want {one}")
        planar = torch.as_tensor(to_planar(crop), device=DEVICE)
        lab_l = planar_bgr2lab(planar)[0]
        th, tw = -(-h // tiles), -(-w // tiles)
        clip = max(int(3.0 * th * tw / 256), 1)
        hist, lut = kc.clahe_hist_luts(lab_l, th, tw, tiles, clip)
        want_hist, want_lut = kc.clahe_hist_luts_reference(lab_l, th, tw, tiles, clip)
        applied = kc.clahe_apply(lab_l, lut, th, tw, tiles)
        lit = correct_lighting(planar)
        smooth = kb.bilateral_planar(lit)
        check(torch.equal(hist, want_hist) and torch.equal(lut, want_lut),
              f"clahe_hist_luts {h}x{w}: differs from plain")
        check(torch.equal(applied, kc.clahe_apply_reference(lab_l, want_lut, th, tw, tiles)),
              f"clahe_apply {h}x{w}: differs from plain")
        check(torch.equal(smooth, kb.bilateral_reference(lit)),
              f"bilateral {h}x{w}: differs from plain")
        cpu = api.enhance_frame(crop, device="cpu")
        d = np.abs(out.astype(int) - cpu.astype(int))
        check(out.shape == crop.shape and d.max() <= ENHANCE_MAX_DIFF
              and (d > 0).mean() <= ENHANCE_FRACTION,
              f"enhance_frame {h}x{w}: card vs CPU max diff {d.max()}, {int((d > 0).sum())} "
              "pixels differ")
        call = call_ms(lambda: api.enhance_frame(crop, device=DEVICE))
        phase("footage", f"enhance_frame {h}x{w} (tiles {th}x{tw}, apply "
              f"{'word' if w % 4 == 0 else 'byte'} path): B2, B3, B4 bit-equal to their plain "
              f"versions on the card; card vs CPU: {int((d > 0).sum())} of {d.size} values "
              f"differ, max {int(d.max())} (limits {ENHANCE_MAX_DIFF}, {ENHANCE_FRACTION:g}); "
              f"{call:.3f} ms a call (median of 5, host clock, synchronized) on {smi}")


RESAMPLE_PLAN_BYTES = 13  # a sample's plan as the kernel reads it: i32 index, f32 fx, fy, u8 flags
RESAMPLE_BOARDS, RESAMPLE_JITTER_PX = 8, 40  # the halls' rigs (benchmark/configs/hall_1080p.json)


def resample_bound(frames, plan, dims):
    """The resample's bound as a function: the source pixels its taps touch
    (of each board's live samples, each pixel read once) and the u8 samples
    written once, at the memory rate. Beside it, the ms of reading the
    plan once in the kernel's layout (13 bytes a sample), which is this
    kernel's choice and not the function's. (bound ms, bound_by, plan ms,
    source bytes touched)."""
    n, c, _, w = frames.shape
    index = plan.src_index.reshape(n, -1).long()
    live = (plan.tap_flags.reshape(n, -1) & mr.ZERO) == 0
    touched = 0
    for i, keep in zip(index, live):
        i = i[keep]
        touched += torch.unique(torch.cat([i, i + 1, i + w, i + w + 1])).numel()
    samples = n * 64 * dims.q_rows * dims.q_cols
    bound_ms, bound_by = bound(c * (touched + samples), 0, F32_FLOPS)
    return bound_ms, bound_by, samples * RESAMPLE_PLAN_BYTES / HBM_BYTES_PER_S * 1e3, c * touched


def resample_phase(smi):
    """The resample kernel (kernels/resample.cu, port-only) at the halls'
    shapes: 8 rigs around the benchmark's board, each corner moved by up to
    40 px; the 1080p hall's square plans on the 8 frames' gray (C = 1) and
    the enhanced hall's tile plans on the planar view of the 8 HWC frames (C
    = 3), random u8. One launch each, bit-equal to the plain chain on the
    card; its time alone (launch_ms's median record, held_ms beside) against
    the plain chain's, its bound (resample_bound) and the plan's read.
    Returns the JSON record of the 1080p hall's squares."""
    rng = np.random.default_rng(9)
    base = bench_corners(HEIGHT, WIDTH)
    geos = [BoardGeometry.from_calibration(
        np.rint(base + rng.uniform(-RESAMPLE_JITTER_PX, RESAMPLE_JITTER_PX, base.shape))
        .astype(np.int64), display_size=(WIDTH, HEIGHT)) for _ in range(RESAMPLE_BOARDS)]
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    hwc = torch.randint(0, 256, (RESAMPLE_BOARDS, HEIGHT, WIDTH, 3), dtype=torch.uint8,
                        device=DEVICE, generator=gen)
    planar = hwc.movedim(-1, -3)
    record = None
    for label, frames, tiles in (("hall squares", planar_bgr2gray(planar)[:, None], False),
                                 ("enhanced hall tiles", planar, True)):
        plans = [mr.build_plan(*(g.board_tile_query_coords()[:2] if tiles
                                 else g.square_query_coords()), g.src_h, g.src_w, device=DEVICE)
                 for g in geos]
        plan, dims = mr.stack_plans([p for p, _ in plans]), plans[0][1]
        before = kr.resample_u8.launches
        got = mr.resample_boards_u8(frames, plan, dims)
        check(kr.resample_u8.launches == before + 1,
              f"resample ({label}): {kr.resample_u8.launches - before} launches, not 1")
        check(torch.equal(got, mr.resample_boards_plain(frames, plan, dims)),
              f"resample ({label}): the kernel differs from the plain chain")
        kernel_ms, plain_ms, held = kernel_vs_plain_ms(
            lambda: mr.resample_boards_u8(frames, plan, dims),
            lambda: mr.resample_boards_plain(frames, plan, dims), 20)
        bound_ms, bound_by, plan_ms, touched = resample_bound(frames, plan, dims)
        n, c = frames.shape[:2]
        phase("resample", f"{label} ({n} boards x {c} channel(s) x 64 x {dims.q_rows}x"
              f"{dims.q_cols}): bit-equal to the plain chain, one launch; kernel "
              f"{kernel_ms * 1e3:.1f} us (held-stream {held * 1e3:.1f} us), plain chain "
              f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us by {bound_by} (the "
              f"{touched / 1e6:.2f} MB of source its taps touch and the output; "
              f"{bound_ms / kernel_ms:.0%} of it); the {RESAMPLE_PLAN_BYTES}-byte plan's read "
              f"alone {plan_ms * 1e3:.1f} us ({(bound_ms + plan_ms) / kernel_ms:.0%} with the "
              f"bound); no library call; on {smi}")
        if record is None:
            record = dict(name="resample", route="cuda",
                          source="chessboard_vision_tpu_torch/kernels/resample.cu",
                          replaces=None, max_abs_err=0, ms=kernel_ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return record


def whole_frame_phase(frame, smi, label="api.enhance_frame's shape", where="kernel"):
    """B2-B4 on a whole camera frame (api.enhance_frame's 1080x1920 shape;
    the ui phase gives enhance_demo's 720x1280 one). B2 on the rendered frame
    and on random u8 (the frame's flat background is a best case for its
    color-weight lookups), B3 and B4 on the frame's Lab-L, B3 beside
    torch.bincount of the pad's keys; each line gives the profiler's records
    a call seen (launch_ms) and the median time of a call between CUDA events
    with the stream held (held_ms), which needs no profiler."""
    tiles = 8
    lit = correct_lighting(on_card(to_planar(frame)))
    C, h, w = lit.shape
    g = torch.Generator(device=DEVICE).manual_seed(2)
    rand = correct_lighting(torch.randint(0, 256, lit.shape, device=DEVICE, generator=g,
                                          dtype=torch.uint8))
    check(torch.equal(kb.bilateral_planar(rand), kb.bilateral_reference(rand)),
          f"bilateral random {h}x{w}: differs from plain")
    lab_l = planar_bgr2lab(lit)[0]
    th, tw = -(-h // tiles), -(-w // tiles)
    clip = max(int(3.0 * th * tw / 256), 1)
    lut = kc.clahe_hist_luts(lab_l, th, tw, tiles, clip)[1]
    bil_bound = bound(2 * C * h * w, BILATERAL_TAPS * BILATERAL_FLOPS_PER_TAP * h * w, F32_FLOPS)
    n_lut = tiles * tiles * 256
    rows = (
        ("bilateral", lambda: kb.bilateral_planar(lit), lambda: kb.bilateral_reference(lit),
         10, bil_bound),
        ("bilateral on random u8", lambda: kb.bilateral_planar(rand),
         lambda: kb.bilateral_reference(rand), 10, bil_bound),
        ("clahe_hist_luts", lambda: kc.clahe_hist_luts(lab_l, th, tw, tiles, clip),
         lambda: kc.clahe_hist_luts_reference(lab_l, th, tw, tiles, clip), 100,
         bound(h * w + 8 * n_lut, th * tiles * tw * tiles, F32_FLOPS)),
        ("clahe_apply", lambda: kc.clahe_apply(lab_l, lut, th, tw, tiles),
         lambda: kc.clahe_apply_reference(lab_l, lut, th, tw, tiles), 100,
         bound(2 * h * w + 4 * n_lut, 10 * h * w, F32_FLOPS)),
    )
    library = {"clahe_hist_luts": clahe_bincount(lab_l, tiles)}
    parts = []
    for name, kernel, plain, iters, b in rows:
        ms, plain_ms, held = kernel_vs_plain_ms(kernel, plain, iters)
        _, seen, expected = launch_ms(kernel, iters)
        lib = (f"; torch.bincount of the pad's keys {device_ms(library[name], iters) * 1e3:.1f}"
               if name in library else "")
        parts.append(f"{name} {ms * 1e3:.1f} ({seen:.2f} records a call seen of {expected:.2f} "
                     f"launches, padded window; held-stream "
                     f"CUDA events {held * 1e3:.1f}; plain "
                     f"{plain_ms * 1e3:.1f}{lib}, bound "
                     f"{b[0] * 1e3:.2f} {b[1]}, {b[0] / ms:.0%} of it)")
    phase(where, f"whole {h}x{w} frame ({label}; tiles {th}x{tw}), device "
          "us/call vs plain and bound: " + "; ".join(parts) + f"; on {smi}")


# The live phase: play_lichess's loop on a LichessSession at the live
# driver's capture size, with drift re-calibration.
LIVE_HEIGHT, LIVE_WIDTH = play_lichess.HEIGHT, play_lichess.WIDTH
LIVE_CORNERS = np.array([[260, 80], [1020, 95], [240, 640], [1035, 655]])  # tests/fixtures.py
LIVE_BUMP = np.array([12, 7])  # a rigid camera nudge, px
LIVE_FPS = 30.0  # the camera's rate
# The scripted camera: (frames, position after these moves, bumped).
LIVE_SCRIPT = ((45, 0, False), (75, 1, False), (60, 2, False), (90, 2, True), (90, 3, True))
LIVE_MOVES = ("e2e4", "e7e5", "g1f3")  # white, the opponent (from the stream), white
LIVE_INTERVAL = 15  # drift_check_interval of the live session, in processed frames
LIVE_RENDERS = 8  # distinct renders a (position, corners), cycled
LIVE_STREAMS, LIVE_STREAM_INTERVAL = 8, 5
LIVE_TICKS = 60  # bound on the ticks of each stage of the multi-stream games
DRIFT_REPS = 5


class ScriptedCamera:
    """A camera over rendered frames, read at ``fps`` at most (read blocks
    until the next frame is due, as a camera's does); once the script is
    over it reports no frame, as an unplugged camera does."""

    def __init__(self, frames, fps):
        self._frames, self._period, self._next = frames, 1.0 / fps, 0
        self._due = None
        self.done = threading.Event()

    def read(self):
        if self._next >= len(self._frames):
            self.done.set()
            time.sleep(self._period)
            return False, None
        now = time.perf_counter()
        if self._due is not None and now < self._due:
            time.sleep(self._due - now)
        self._due = max(self._due or now, now) + self._period
        self._next += 1
        return True, self._frames[self._next - 1]

    def release(self):
        self._next = len(self._frames)


class ScriptedLichess:
    """The Board API surface LichessSession uses, in memory: POSTs are
    recorded and accepted; the stream echoes each of our moves and answers
    e2e4 with the opponent's e7e5 after ``reply_s``."""

    def __init__(self, reply_s=0.2):
        self.sent, self.my_color, self.clock = [], "white", None
        self._moves, self._events, self.reply_s = [], queue.Queue(), reply_s

    def connect(self):
        return True

    def get_ongoing_games(self):
        return [{"gameId": "smoke1"}]

    def make_move(self, uci):
        self.sent.append(uci)
        self._moves.append(uci)
        self._events.put((0.0, " ".join(self._moves)))
        if uci == LIVE_MOVES[0]:
            self._moves.append(LIVE_MOVES[1])
            self._events.put((self.reply_s, " ".join(self._moves)))
        return True

    def is_my_turn(self, moves):
        return (len(moves.split()) if moves else 0) % 2 == 0

    def get_last_move(self, moves):
        return moves.split()[-1] if moves else None

    def handle_draw_offer(self, accept):
        return True

    def stream_game_with_reconnect(self, game_id, stop_check=None):
        yield {"type": "gameFull", "state": {"moves": "", "status": "started"}}
        while not stop_check():
            try:
                delay, moves = self._events.get(timeout=0.02)
            except queue.Empty:
                continue
            time.sleep(delay)
            yield {"type": "gameState", "status": "started", "moves": moves}


def live_boards():
    boards = [rules_chess.Board()]
    for uci in LIVE_MOVES:
        b = rules_chess.Board(boards[-1].fen())
        b.push_uci(uci)
        boards.append(b)
    return boards


def drift_split_ms(frame, reps=DRIFT_REPS):
    """The median ms of one drift check's three parts on a frame (host
    clock, the card synchronized): the image stages on the card (upload,
    the ~60 torch ops, the Canny's readbacks), the D2H of the mask, and the
    host contour stages; and the corners found."""
    parts = [[], [], []]
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mask = geometry.board_edge_mask(frame, DEVICE)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = mask.cpu().numpy()
        t2 = time.perf_counter()
        found = geometry.corners_from_mask(host)
        t3 = time.perf_counter()
        if i:  # the first call warms up
            for part, t in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                part.append(t * 1e3)
    return [float(np.median(p)) for p in parts], found


def _pct(xs, q):
    return float(np.percentile(xs, q)) if xs else float("nan")


def live_game_phase(smi, launches):
    """play_lichess.run through the frame ring on a LichessSession on the
    card with a scripted client: e2e4 committed and POSTed, e7e5 from the
    stream, a camera bump healed by a rebuilt geometry, g1f3 committed at
    the new corners; the final FEN and the PGN as scripted."""
    boards = live_boards()
    bumped = LIVE_CORNERS + LIVE_BUMP
    cams = {False: SynthCamera(LIVE_CORNERS, frame_size=(LIVE_HEIGHT, LIVE_WIDTH)),
            True: SynthCamera(bumped, frame_size=(LIVE_HEIGHT, LIVE_WIDTH))}
    kinds = sorted({(pos, bump) for _, pos, bump in LIVE_SCRIPT} | {(0, False)})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        renders = dict(zip(kinds, pool.map(
            lambda k: [cams[k[1]].render(occupancy_of(boards[k[0]]),
                                         np.random.default_rng((40, k[0], k[1], i)))
                       for i in range(LIVE_RENDERS)], kinds)))
    frames = [renders[0, False][i % LIVE_RENDERS] for i in range(11)]  # the calibration's
    for n, pos, bump in LIVE_SCRIPT:
        frames += [renders[pos, bump][i % LIVE_RENDERS] for i in range(n)]
    phase("live", f"rendered {len(kinds) * LIVE_RENDERS} frames of {LIVE_WIDTH}x{LIVE_HEIGHT} "
          f"in {time.perf_counter() - t0:.1f} s; the camera plays {len(frames)} at "
          f"{LIVE_FPS:g} fps")

    client = ScriptedLichess()
    camera = ScriptedCamera(frames, LIVE_FPS)
    config = {"corners": LIVE_CORNERS.tolist(), "player_color": "white",
              "orientation_flipped": False, "auto_recalibrate": True,
              "drift_check_interval": LIVE_INTERVAL}
    with counted(launches) as got:
        session = LichessSession(client=client, device=DEVICE)
        check(session.on_calibration_requested(camera, config=config),
              "live: calibration from the camera failed")
        check(session.drift is not None and session.drift._baseline is not None,
              "live: the calibration frame did not seed the drift baseline")
        check(session.connect_and_setup(interactive=False) and session.game_id == "smoke1",
              "live: connect_and_setup with the scripted client failed")
        steps, recals = {"check": [], "plain": []}, []
        on_frame, recalibrate = session.on_frame, session._recalibrate

        def timed_on_frame(img):
            t = time.perf_counter()
            move = on_frame(img)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            if recals and recals[-1][0] == session.frame_count:
                recals[-1] += (ms,)  # the frame that recalibrated: timed apart
            else:
                steps["check" if session.frame_count % LIVE_INTERVAL == 0 else "plain"].append(ms)
            return move

        def timed_recalibrate(corners, frame):
            torch.cuda.synchronize()
            t = time.perf_counter()
            recalibrate(corners, frame)
            torch.cuda.synchronize()
            recals.append((session.frame_count, (time.perf_counter() - t) * 1e3))

        session.on_frame, session._recalibrate = timed_on_frame, timed_recalibrate

        def wait_key(ms):  # cv2.waitKey's wait, and 'q' once the camera is over
            time.sleep(ms / 1e3)
            return ord("q") if camera.done.is_set() else -1

        with tempfile.TemporaryDirectory() as tmp:
            pgn_path = os.path.join(tmp, "game.pgn")
            t0 = time.perf_counter()
            result = play_lichess.run(session, camera, wait_key, use_ring=True, pgn=pgn_path)
            wall = time.perf_counter() - t0
            with open(pgn_path) as fh:
                pgn = fh.read()
        session._stream_thread.join(timeout=5)
    check(not session._stream_thread.is_alive(), "live: the stream thread did not end")
    check(client.sent == [LIVE_MOVES[0], LIVE_MOVES[2]],
          f"live: the client received the POSTs {client.sent}, want e2e4 and g1f3")
    check(len(recals) == 1, f"live: {len(recals)} recalibrations, want 1")
    got_corners = np.asarray(session.config["corners"], np.float64)
    err = float(np.abs(got_corners - bumped).max())
    check(err <= 2.0, f"live: recalibrated to {session.config['corners']}, bumped truth "
          f"{bumped.tolist()} ({err} px off)")
    check(session.game.get_fen() == boards[-1].fen(),
          f"live: FEN {session.game.get_fen()} != scripted {boards[-1].fen()}")
    check("1. e4 e5 2. Nf3" in pgn and pgn == session.to_pgn(),
          f"live: the PGN does not hold the three moves:\n{pgn}")
    check(got["score_matmul"] >= result.frames,
          f"live: B1 launched {got['score_matmul']} times for {result.frames} steps")
    check(not any(got[k] for k in ENHANCEMENT),
          f"live: the plain live path launched an enhancement kernel: {got}")
    check(got["resample"] >= result.frames,
          f"live: the resample launched {got['resample']} times for {result.frames} steps")
    (dev, d2h, host), found = drift_split_ms(frames[-1])
    check(np.abs(found.reshape(4, 2) - bumped).max() <= 10, f"live: detector found {found}")
    frame_no, recal_ms, recal_frame_ms = recals[0]
    phase("live", f"play_lichess.run through the frame ring at {LIVE_WIDTH}x{LIVE_HEIGHT}: "
          f"{result.frames} frames stepped of {len(frames) - 11} in {wall:.1f} s ({result.skipped} "
          f"passed over to step the newest, {result.dropped} dropped by the ring); POSTed {client.sent}, e7e5 from the stream; the bump healed on "
          f"frame {frame_no} to corners {session.config['corners']} ({err} px from the bumped "
          f"truth); FEN {session.game.get_fen()}; PGN 1. e4 e5 2. Nf3; launches {got}")
    phase("live", f"on_frame (host clock, synchronized): without a check p50 "
          f"{_pct(steps['plain'], 50):.3f} / p95 {_pct(steps['plain'], 95):.3f} ms "
          f"({len(steps['plain'])} frames), with a drift check p50 "
          f"{_pct(steps['check'], 50):.3f} / p95 {_pct(steps['check'], 95):.3f} ms "
          f"({len(steps['check'])} frames); the recalibrating frame {recal_frame_ms:.3f} ms, "
          f"of which _recalibrate (pipeline build + reference capture) {recal_ms:.3f} ms; "
          f"one drift check at {LIVE_WIDTH}x{LIVE_HEIGHT} (median of {DRIFT_REPS}): image "
          f"stages on the card {dev:.3f} ms, D2H of the mask {d2h:.3f} ms, host contours "
          f"{host:.3f} ms; on {smi}")


def live_streams_phase(smi, launches):
    """MultiStreamSession(auto_recalibrate=True) at 1080p on the benchmark's
    layout: rig 0 bumped, one rebuild in per-stream-geometry mode, then every
    rig commits e2e4; once with LIVE_STREAMS plain streams, once enhanced
    with two (B2-B4 on rebuilt per-stream tile plans)."""
    corners = bench_corners(HEIGHT, WIDTH)
    g = BoardGeometry.from_calibration(corners, display_size=(WIDTH, HEIGHT))
    bumped = corners + LIVE_BUMP
    cams = {b: SynthCamera(c, frame_size=(HEIGHT, WIDTH), board_px=g.board_size)
            for b, c in ((False, corners), (True, bumped))}
    start, after = live_boards()[:2]
    kinds = [(b, bump) for b in (0, 1) for bump in (False, True)]
    with ThreadPoolExecutor(8) as pool:
        renders = dict(zip(kinds, pool.map(
            lambda k: [cams[k[1]].render(occupancy_of((start, after)[k[0]]),
                                         np.random.default_rng((41, k[0], k[1], i)))
                       for i in range(3)], kinds)))
    (dev, d2h, host), found = drift_split_ms(renders[0, True][0])
    check(np.abs(found.reshape(4, 2) - bumped).max() <= 10, f"live streams: found {found}")
    phase("live", f"one drift check at {WIDTH}x{HEIGHT} (median of {DRIFT_REPS}): image stages "
          f"on the card {dev:.3f} ms, D2H of the mask {d2h:.3f} ms, host contours {host:.3f} "
          f"ms; on {smi}")

    def tick(t, n, pos, bump):
        return np.stack([renders[pos, bump and s == 0][(t + s) % 3] for s in range(n)])

    for n, enhanced in ((LIVE_STREAMS, False), (2, True)):
        label = f"{'enhanced ' if enhanced else ''}{n} streams"
        with counted(launches) as got:
            sess = MultiStreamSession(g, n, auto_recalibrate=True,
                                      drift_check_interval=LIVE_STREAM_INTERVAL,
                                      with_enhancer=enhanced, device=DEVICE)
            sess.MOVE_COOLDOWN = 0.0
            sess.capture_reference(tick(0, n, 0, False))
            checks, check_drift = [], sess._check_drift

            def timed_check(frames):
                torch.cuda.synchronize()
                t = time.perf_counter()
                check_drift(frames)
                torch.cuda.synchronize()
                checks.append(((time.perf_counter() - t) * 1e3, sess.ms._stream_plans is not None))

            sess._check_drift = timed_check
            for t in range(LIVE_STREAM_INTERVAL):
                check(not any(sess.on_frames(tick(t, n, 0, False))), f"{label}: early commit")
            t = 0
            while sess.ms._stream_plans is None and t < LIVE_TICKS:
                sess.on_frames(tick(t, n, 0, True))
                t += 1
            check(sess.ms._stream_plans is not None, f"{label}: no per-stream rebuild")
            rebuilt_at = sess.frame_count
            err = float(np.abs(np.asarray(sess.geometries[0].src_corners) - bumped).max())
            check(err <= 2.0, f"{label}: rig 0 recalibrated {err} px off the bumped truth")
            check(all(np.array_equal(geo.src_corners, corners) for geo in sess.geometries[1:]),
                  f"{label}: an unbumped rig's corners moved")
            before = {name: fn.launches for name, fn in COUNTERS.items()}
            committed = [None] * n
            for t in range(LIVE_TICKS):
                for s, m in enumerate(sess.on_frames(tick(t, n, 1, True))):
                    if m:
                        committed[s] = m.uci()
                if all(committed):
                    break
            after_rebuild = {name: fn.launches - before[name] for name, fn in COUNTERS.items()}
        ticks = sess.frame_count - rebuilt_at
        k = ticks if enhanced else 0
        want = {"score_matmul": ticks, "bilateral": k, "clahe_hist": 0, "clahe_hist_luts": k,
                "clahe_apply": k, "resample": ticks}
        check(after_rebuild == want, f"{label}: launches on the rebuilt per-stream plans "
              f"{after_rebuild}, want {want} (B1 and the resample once a tick, B2-B4 once a "
              f"tick for the {n} boards)")
        check(all(st.game.get_fen() == after.fen() for st in sess.streams), f"{label}: FEN")
        check(got["score_matmul"] >= sess.frame_count, f"{label}: B1 launches {got}")
        plain = [ms for ms, rebuilt in checks if not rebuilt]
        confirming = [ms for ms, rebuilt in checks if rebuilt][0]
        # The rebuild alone, as _check_drift makes it: the per-stream
        # pipeline and the reference capture of one tick's frames.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms = tms.MultiStreamPipeline(sess.geometries, n_streams=n, **sess._pipeline_kw)
        ms.capture_reference(ms.init_state(), tick(0, n, 1, True))
        torch.cuda.synchronize()
        rebuild = (time.perf_counter() - t0) * 1e3
        del ms
        phase("live", f"MultiStreamSession, {label} at {WIDTH}x{HEIGHT}, rig 0 bumped: rebuilt in "
              f"per-stream-geometry mode on tick {rebuilt_at} (rig 0 {err} px from the bumped "
              f"truth, the others unchanged), then every rig committed e2e4 by tick "
              f"{sess.frame_count}; drift check of {n} rigs {np.median(plain):.3f} ms (median of "
              f"{len(plain)}), the confirming tick's checks + rebuild + reference capture "
              f"{confirming:.3f} ms, a rebuild alone (pipeline build + reference capture) "
              f"{rebuild:.3f} ms; launches {got}, {after_rebuild} of them on the rebuilt plans "
              f"over {ticks} ticks; on {smi}")


def live_phase(smi):
    """The live path, with every count set to 0 just before each call of
    the path and read just after it. Returns the path's counts."""
    launches = collections.Counter()
    live_game_phase(smi, launches)
    live_streams_phase(smi, launches)
    counts = {name: launches[name] for name in COUNTERS}
    phase("live", f"kernel launches on this path: {counts} (B1: {counts['score_matmul']})")
    return counts


# The ui phase: the tools of tools/ and the session's radar at the tools'
# 1280x720 capture, through a stand-in for cv2's HighGUI (the card's
# machine has no cv2).
UI_HEIGHT, UI_WIDTH = play_lichess.HEIGHT, play_lichess.WIDTH
UI_CORNERS = LIVE_CORNERS
UI_STILL = 16  # frames each tuner setting is held: the rebuild fires on the 16th
UI_RENDERS = 6  # distinct renders of a position, cycled
UI_ENHANCE_FRAMES = 8
UI_RADIUS_EXTREMES = {"Min radius %": 5, "Max radius %": 80}
UI_PARAMS = {"Param1": 80, "Param2": 20, "Center diff": 30}
UI_PROFILE_BARS = {"Hue shift": 100, "Sat x10": 14, "Contrast x10": 12, "Brightness": 110,
                   "Radical": 1, "Target hue": 15, "Hue window": 30}
UI_DEMO_PROFILE = {"contrast": 1.1, "brightness": 4, "sat_scale": 1.2}
DARK_PIECE = (40, 36, 30)


class StandInGui:
    """cv2's HighGUI and drawing calls, stood in for: the tools call what
    cv2 offers, this object answers. The frame clock is ``waitKey``, which
    each tool calls once a shown frame: trackbar moves and clicks scripted
    for frame n land before frame n's positions are read and after frame
    n's image is shown (a click then shows on frame n + 1), and waitKey
    returns frame n's key. Drawing calls are recorded with their frame, not
    painted; imshow records the image. warpPerspective and rotate are the
    port's own warp and a flip on the card, cvtColor's BGR -> gray is the
    port's bgr2gray on the card, resize records its factors and returns the
    image."""

    FONT_HERSHEY_SIMPLEX, EVENT_LBUTTONDOWN, ROTATE_180 = 0, 1, 1  # cv2's values
    COLOR_BGR2GRAY, COLOR_GRAY2BGR = 6, 8

    def __init__(self, bars=None, keys=None, clicks=None):
        self.bars, self.keys, self.clicks = bars or {}, keys or {}, clicks or {}
        self.frames = 0  # waitKey calls so far: the current frame is frames + 1
        self.positions, self.callbacks = {}, {}
        self.calls, self.shown, self.ticks = [], [], []
        self.destroyed = 0

    def _record(self, name, *args):
        self.calls.append((self.frames + 1, name, args))

    def namedWindow(self, name, *args):
        pass

    def createTrackbar(self, name, window, value, vmax, callback):
        self.positions[name] = value

    def getTrackbarPos(self, name, window):
        for frame in sorted(f for f in self.bars if f <= self.frames + 1):
            self.positions.update(self.bars.pop(frame))
        return self.positions[name]

    def setMouseCallback(self, window, callback, *args):
        self.callbacks[window] = callback

    def imshow(self, window, img):
        self.shown.append((self.frames + 1, window, np.array(img, copy=True)))

    def waitKey(self, ms=0):
        self.frames += 1
        self.ticks.append(time.perf_counter())
        for x, y in self.clicks.get(self.frames, ()):
            for callback in self.callbacks.values():
                callback(self.EVENT_LBUTTONDOWN, x, y, 0, None)
        return self.keys.get(self.frames, -1)

    def destroyAllWindows(self):
        self.destroyed += 1

    def circle(self, img, center, radius, color, thickness=1, *args):
        self._record("circle", tuple(map(int, center)), int(radius), tuple(color))

    def line(self, img, p1, p2, color, thickness=1, *args):
        self._record("line", p1, p2, tuple(color))

    def rectangle(self, img, p1, p2, color, thickness=1, *args):
        self._record("rectangle", p1, p2, tuple(color), thickness)

    def putText(self, img, text, org, font, scale, color, thickness=1, *args):
        self._record("putText", text, org)

    def polylines(self, img, pts, closed, color, thickness=1, *args):
        self._record("polylines", [p.reshape(-1, 2).tolist() for p in pts])

    def addWeighted(self, src1, alpha, src2, beta, gamma, dst=None):
        self._record("addWeighted", alpha, beta)
        return dst

    def resize(self, img, dsize, fx=1.0, fy=1.0, *args):
        self._record("resize", fx, fy)
        return img

    def cvtColor(self, img, code):
        if code == self.COLOR_BGR2GRAY:
            return bgr2gray(on_card(img)).cpu().numpy()
        if code == self.COLOR_GRAY2BGR:
            return np.repeat(img[..., None], 3, axis=-1)
        raise ValueError(f"StandInGui.cvtColor: code {code}")

    def warpPerspective(self, img, M, dsize):
        w, h = dsize
        X, Y = geometry.inverse_coord_maps(M, h, w)
        return warp_ops.warp_bilinear(on_card(img), on_card(X), on_card(Y),
                                      contract=False).cpu().numpy()

    def rotate(self, img, code):
        check(code == self.ROTATE_180, f"StandInGui.rotate: code {code}")
        return torch.flip(on_card(img), (0, 1)).cpu().numpy()

    def drawn(self, frame, name):
        return [args for f, n, args in self.calls if f == frame and n == name]

    def frame_ms(self, skip=()):
        """ms between successive frames (the first frame has no interval),
        leaving out the frames in ``skip``."""
        return [(b - a) * 1e3 for i, (a, b) in enumerate(zip(self.ticks, self.ticks[1:]), 2)
                if i not in skip]


class TimedBuilds:
    """A tool module's VisionPipeline, timed: each build (the plan on the
    card) and the reference capture of each built pipeline, apart."""

    def __init__(self, module):
        self.module, self.cls, self.builds = module, module.VisionPipeline, []

    def __enter__(self):
        self.module.VisionPipeline = self.build
        return self

    def __exit__(self, *exc):
        self.module.VisionPipeline = self.cls

    def build(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe = self.cls(*args, **kw)
        torch.cuda.synchronize()
        record = {"pipe": pipe, "kw": kw, "build_ms": (time.perf_counter() - t0) * 1e3}
        capture = pipe.capture_reference

        def timed_capture(state, frame):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state = capture(state, frame)
            torch.cuda.synchronize()
            record.setdefault("capture_ms", (time.perf_counter() - t) * 1e3)
            return state

        pipe.capture_reference = timed_capture
        self.builds.append(record)
        return pipe

    def text(self):
        return ", ".join(f"{b['build_ms']:.3f} + {b['capture_ms']:.3f}" for b in self.builds)


class UiCamera:
    """A capture over rendered frames (read, release)."""

    def __init__(self, frames):
        self._frames, self._next = frames, 0

    def read(self):
        if self._next >= len(self._frames):
            return False, None
        self._next += 1
        return True, self._frames[self._next - 1].copy()

    def release(self):
        pass


def ui_renders(camera, occ, seed, n=UI_RENDERS, **kw):
    return [camera.render(occ, np.random.default_rng((seed, i)), **kw) for i in range(n)]


def b1_operands(pipe, frames, label):
    """B1's operands as steps of ``pipe`` hand them over (captured on the
    way in): the plan's basis and the pooled planes of every frame, one
    step a frame, stacked (N = 64 a frame). The steps are one-frame
    ``step_many`` calls, which run eagerly: a graphed ``step`` replays B1
    without calling its wrapper."""
    from chessboard_vision_tpu_torch.ops import hough_conv

    seen = []
    real = hough_conv.score_matmul
    hough_conv.score_matmul = lambda a, b: seen.append((a, b)) or real(a, b)
    try:
        for frame in frames:
            pipe.step_many(pipe.init_state(), frame[None])
    finally:
        hough_conv.score_matmul = real
    check(len(seen) == len(frames), f"{label}: {len(seen)} B1 calls in {len(frames)} steps")
    return seen[0][0], torch.cat([b for _, b in seen])


def b1_at_plan(pipe, frame, label, timed=True):
    """B1 on the inputs one step of ``pipe`` hands it, against its plain
    version: within tolerance, the masked first-max argmax equal; the
    kernel's path (the TMA kernel) and the shape; with ``timed``, its
    device time beside the plain version's, the library call's and the
    bound. Launches made here are the comparison's, outside any counted
    window."""
    basis, planes = b1_operands(pipe, [frame], label)
    got = sm.score_matmul(basis, planes)
    path, shape = sm.score_matmul.last_path, sm.score_matmul.last_shape
    check(path == "tma", f"{label}: B1 took the {path} path at {shape}")
    want = sm.score_matmul_reference(basis, planes)
    torch.testing.assert_close(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)
    kvalid = pipe.consts.conv_plan.kvalid
    gi = torch.argmax(torch.where(kvalid, got, -torch.inf), dim=0)
    wi = torch.argmax(torch.where(kvalid, want, -torch.inf), dim=0)
    flips = (gi != wi).nonzero().flatten().tolist()
    check(not flips, f"{label}: B1 argmax differs from plain on squares {flips}")
    err = (got - want).abs().max().item()
    line = f"B1 (M, N, K) {shape} on the {path} kernel, max_abs_err {err!r}, argmax equal"
    if not timed:
        return err, line
    (M, K), N = basis.shape, planes.shape[0]
    bound_ms, bound_by = b1_bound(M, N, K)
    kernel_ms, plain_ms, _ = kernel_vs_plain_ms(lambda: sm.score_matmul(basis, planes),
                                                lambda: sm.score_matmul_reference(basis, planes),
                                                100)
    library = library_mm(basis, planes)
    library_ms = device_ms(library[1], 100)
    return err, (f"{line}, device {kernel_ms * 1e3:.1f} us/call, plain (cuBLAS f32) "
                 f"{plain_ms * 1e3:.1f} us, {library[0]} {library_ms * 1e3:.1f} us, bound "
                 f"{bound_ms * 1e3:.2f} us ({bound_by})")


def _squares_of_circles(circles, sq):
    return {(cx // sq, 7 - cy // sq) for (cx, cy), _, _ in circles}


def ui_piece_detector(camera, config, truth, launches, smi):
    """calibrate_piece_detector.run: default settings, then the radius
    extremes, then new param1/param2/center_diff, each held UI_STILL frames:
    one rebuild a distinct setting; at the default settings the squares
    circled are the truth; B1 at each rebuilt plan."""
    from chessboard_vision_tpu_torch.tools import calibrate_piece_detector as cpd

    n = 3 * UI_STILL
    frames = [camera[i % len(camera)] for i in range(n)]
    gui = StandInGui(bars={UI_STILL + 1: UI_RADIUS_EXTREMES, 2 * UI_STILL + 1: UI_PARAMS},
                     keys={n: ord("q")})
    with counted(launches) as got, TimedBuilds(cpd) as timed:
        shown = cpd.run(UiCamera(frames), gui, config, device=DEVICE)
    check(shown == n and gui.destroyed == 1, f"ui piece detector: {shown} frames shown")
    rebuilt = [1, 2 * UI_STILL, 3 * UI_STILL]
    settings = [b["kw"]["piece_settings"] for b in timed.builds]
    check(len(timed.builds) == 3 and len({json.dumps(s, sort_keys=True) for s in settings}) == 3,
          f"ui piece detector: {len(timed.builds)} rebuilds for 3 distinct settings: {settings}")
    check(settings[1]["min_radius"] == 5 and settings[1]["max_radius"] == 80
          and settings[2]["param1"] == 80, f"ui piece detector: settings {settings}")
    board = timed.builds[0]["pipe"].geometry.board_size
    drawn = _squares_of_circles(gui.drawn(UI_STILL, "circle"), board // 8)
    check(drawn == truth, f"ui piece detector: squares circled at the default settings "
          f"{sorted(drawn ^ truth)} differ from the truth")
    check(got["score_matmul"] == n and not any(got[k] for k in ENHANCEMENT)
          and got["resample"] >= n, f"ui piece detector: launches {got} for {n} frames")
    errs, lines, shapes = [], [], set()
    for b, (frame, s) in zip(timed.builds, zip(rebuilt, settings)):
        shape = tuple(b["pipe"].consts.conv_plan.basis.shape)
        err, line = b1_at_plan(b["pipe"], frames[frame - 1],
                               f"ui piece detector plan {s['min_radius']}-{s['max_radius']}%",
                               timed=shape not in shapes)  # each plan shape timed once
        shapes.add(shape)
        errs.append(err)
        lines.append(f"{s['min_radius']}-{s['max_radius']}%: {line}")
    per = gui.frame_ms(skip=rebuilt)
    phase("ui", f"calibrate_piece_detector.run at {UI_WIDTH}x{UI_HEIGHT}: {n} frames, "
          f"{len(timed.builds)} rebuilds on frames {rebuilt}, the {len(drawn)} squares circled "
          f"at the default settings equal the truth; ms a frame p50 {_pct(per, 50):.3f} / p95 "
          f"{_pct(per, 95):.3f} (host clock, the tool's reads back); ms a rebuild (plan build + "
          f"reference capture) {timed.text()}; launches {got}; " + "; ".join(lines)
          + f"; on {smi}")
    return max(errs)


def ui_sensitivity(renders, config, launches, smi):
    """calibrate_sensitivity.run: blur 9 rebuilds the geometry with blur_pad
    4, then the e2 pawn lifted: the preview marks e2 and circles e3, e4."""
    from chessboard_vision_tpu_torch.tools import calibrate_sensitivity as cs

    start, lifted = renders
    n_start, n_lifted = UI_STILL + 1, 4
    frames = [start[i % len(start)] for i in range(n_start)]
    frames += [lifted[i % len(lifted)] for i in range(n_lifted)]
    n = len(frames)
    gui = StandInGui(bars={2: {"Blur": 9, "Sensitivity": 20}}, keys={n: ord("q")})
    with counted(launches) as got, TimedBuilds(cs) as timed:
        shown = cs.run(UiCamera(frames), gui, config, device=DEVICE)
    pads = [b["pipe"].geometry.squares.pad for b in timed.builds]
    check(shown == n and pads == [2, 4],
          f"ui sensitivity: {shown} frames, rebuilds with blur_pad {pads} (want [2, 4])")
    check([b["kw"]["change_settings"]["blur_kernel"] for b in timed.builds] == [5, 9],
          "ui sensitivity: blur kernels of the rebuilds")
    sq = timed.builds[-1]["pipe"].geometry.board_size // 8
    marked = [(x // sq, 7 - y // sq) for (x, y), _, color, t in gui.drawn(n, "rectangle")
              if color == (0, 255, 255) and t == 2]
    dests = _squares_of_circles(gui.drawn(n, "circle"), sq)
    check(marked == [(4, 1)] and dests == {(4, 2), (4, 3)},
          f"ui sensitivity: the lifted preview marks {marked} with destinations {sorted(dests)}")
    check(got["score_matmul"] == n and not any(got[k] for k in ENHANCEMENT)
          and got["resample"] >= n, f"ui sensitivity: launches {got} for {n} frames")
    err, line = b1_at_plan(timed.builds[-1]["pipe"], frames[-1], "ui sensitivity",
                           timed=False)  # the default plan's shape, timed above
    per = gui.frame_ms(skip=(1, UI_STILL + 1))
    phase("ui", f"calibrate_sensitivity.run: {n} frames, the blur-9 rebuild with blur_pad 4 on "
          f"frame {UI_STILL + 1}, e2 lifted: marked {marked[0]}, destinations {sorted(dests)}; "
          f"ms a frame p50 {_pct(per, 50):.3f} / p95 {_pct(per, 95):.3f}; ms a rebuild (plan "
          f"build + reference capture) {timed.text()}; launches {got}; {line}; on {smi}")
    return err


def ui_colors(frame, launches, smi):
    """calibrate_colors.run with one non-identity profile: the middle of the
    shown triptych is ImageEnhancer.apply_color_profile of the frame."""
    from chessboard_vision_tpu_torch.models.enhancer import ImageEnhancer
    from chessboard_vision_tpu_torch.tools import calibrate_colors as cc

    gui = StandInGui(bars={1: UI_PROFILE_BARS}, keys={2: ord("q")})
    with counted(launches) as got:
        shown = cc.run(UiCamera([frame, frame]), gui, device=DEVICE)
    profile = cc.profile_from_trackbars(
        [UI_PROFILE_BARS.get(name, default) for name, _m, _c, default in cc.TRACKBARS])
    want = ImageEnhancer(profile=profile, device=DEVICE).apply_color_profile(frame)
    _, window, img = gui.shown[-1]
    w = frame.shape[1]
    check(shown == 2 and img.shape == (frame.shape[0], 3 * w, 3)
          and np.array_equal(img[:, :w], frame) and np.array_equal(img[:, w:2 * w], want),
          "ui colors: the shown triptych is not (frame, apply_color_profile(frame), gray)")
    check(not np.array_equal(want, frame), "ui colors: the profile changed nothing")
    check(not any(got.values()), f"ui colors: launches {got}")
    per = gui.frame_ms()
    phase("ui", f"calibrate_colors.run: profile {profile}; the shown triptych's middle equals "
          f"ImageEnhancer.apply_color_profile of the frame; ms a frame {per[0]:.3f}; launches "
          f"{got}; on {smi}")


def ui_enhance_demo(frames, launches, smi):
    """enhance_demo.run on whole 1280x720 frames with color_profile.json:
    B2, B3 and B4 once a frame each, and each bit-equal to its plain version
    at 720x1280 on the enhancer's own inputs."""
    from chessboard_vision_tpu_torch.models.enhancer import apply_color_profile
    from chessboard_vision_tpu_torch.tools import enhance_demo as ed

    with open("color_profile.json", "w") as fh:
        json.dump(UI_DEMO_PROFILE, fh)
    n = len(frames)
    gui = StandInGui(keys={n: ord("q")})
    with counted(launches) as got:
        shown = ed.run(UiCamera(frames), gui, device=DEVICE)
    want = {"score_matmul": 0, "bilateral": n, "clahe_hist": 0, "clahe_hist_luts": n,
            "clahe_apply": n, "resample": 0}
    check(shown == n and got == want, f"ui enhance demo: launches {got}, want {want}")
    check([w for _, w, _ in gui.shown[:3]] == ["Original", "Enhanced", "Analysis (Otsu)"],
          "ui enhance demo: windows")
    tiles = 8
    planar = apply_color_profile(on_card(to_planar(frames[0])), UI_DEMO_PROFILE)
    lab_l = planar_bgr2lab(planar)[0]
    h, w = lab_l.shape
    th, tw = -(-h // tiles), -(-w // tiles)
    clip = max(int(3.0 * th * tw / 256), 1)
    hist, lut = kc.clahe_hist_luts(lab_l, th, tw, tiles, clip)
    want_hist, want_lut = kc.clahe_hist_luts_reference(lab_l, th, tw, tiles, clip)
    check(torch.equal(hist, want_hist) and torch.equal(lut, want_lut),
          "ui enhance demo: B3 differs from plain at 720x1280")
    check(torch.equal(kc.clahe_apply(lab_l, lut, th, tw, tiles),
                      kc.clahe_apply_reference(lab_l, want_lut, th, tw, tiles)),
          "ui enhance demo: B4 differs from plain at 720x1280")
    lit = correct_lighting(planar)
    check(torch.equal(kb.bilateral_planar(lit), kb.bilateral_reference(lit)),
          "ui enhance demo: B2 differs from plain at 720x1280")
    whole_frame_phase(frames[0], smi, "enhance_demo's camera frame", "ui")
    per = gui.frame_ms()
    phase("ui", f"enhance_demo.run on {n} {w}x{h} frames: B2, B3 and B4 bit-equal to their "
          f"plain versions at {h}x{w} (CLAHE tiles {th}x{tw}); ms a frame p50 "
          f"{_pct(per, 50):.3f} / p95 {_pct(per, 95):.3f} (process_pipeline + prepare_analysis, "
          f"both read back); launches {got}; on {smi}")


def ui_calibrator(frames, launches, smi):
    """CalibrationModule.run: four clicks, ENTER, 'g', 's': the config's
    corners are the clicks, the smart grid is refined on the card. Then a
    GameSession with no saved calibration reaches it from
    on_calibration_requested(cap) and captures its reference on the card."""
    from chessboard_vision_tpu_torch.tools.calibration_module import CalibrationModule

    clicks = [tuple(int(v) for v in UI_CORNERS[i]) for i in (3, 0, 2, 1)]

    def script():
        return StandInGui(clicks={1: clicks}, keys={2: 13, 4: ord("g"), 6: ord("s")})

    gui = script()
    with counted(launches) as got:
        t0 = time.perf_counter()
        config = CalibrationModule(gui=gui, device=DEVICE).run(UiCamera(frames))
        calib_s = time.perf_counter() - t0
    check(config is not None and config["corners"] == [list(c) for c in clicks],
          f"ui calibrator: config {config}")
    check(len(config["grid_lines_x"]) == 9 and len(config["grid_lines_y"]) == 9,
          f"ui calibrator: grid {config['grid_lines_x']} {config['grid_lines_y']}")
    check([w for _, w, _ in gui.shown] == ["Calibration"] * 2 + ["Verification"] * 4
          and gui.shown[-1][2].shape == (620, 620, 3), "ui calibrator: windows shown")
    check(len(gui.drawn(2, "polylines")) == 1, "ui calibrator: the four corners' outline")
    with open("calibration.json") as fh:
        check(json.load(fh) == config, "ui calibrator: calibration.json differs from the config")
    os.remove("calibration.json")
    session = GameSession(device=DEVICE)
    with counted(launches) as session_got:
        ok = session.on_calibration_requested(UiCamera(frames + frames[:11]), gui=script())
    check(ok and session.config == config, f"ui calibrator: session config {session.config}")
    leaves = tree_leaves(session.pipe_state)
    check(leaves and all(t.device.type == torch.device(DEVICE).type for t in leaves),
          "ui calibrator: the reference is not on the card")
    check(not any(got.values()), f"ui calibrator: launches {got}")
    phase("ui", f"CalibrationModule.run: corners {config['corners']} (the clicks), smart grid x "
          f"{config['grid_lines_x']} y {config['grid_lines_y']} (refine_grid on the card) in "
          f"{calib_s * 1e3:.3f} ms for {len(gui.shown)} frames; on_calibration_requested(cap) "
          f"with no saved calibration reached it and captured the reference on the card "
          f"(launches {session_got}); on {smi}")


def ui_radar(camera, config, launches, smi):
    """The session's radar on the card: e2 lifted shows as the lifted square
    with its two destinations."""
    occ = initial_occupancy()
    lifted = occ.copy()
    lifted[4, 1] = False
    frames = ui_renders(camera, occ, 60, 3) + ui_renders(camera, lifted, 61, 5)
    session = GameSession(device=DEVICE)
    with counted(launches) as got:
        session.on_calibration_requested(config=config)
        session.capture_reference_frame(frames[0])
        radar, times = [], []
        for fr in frames[1:]:
            t0 = time.perf_counter()
            session.on_frame(fr)
            times.append((time.perf_counter() - t0) * 1e3)
            radar.append((session.lifted_piece_square, sorted(session.current_radar_destinations)))
    check(radar[0] == (None, []) and radar[-1] == ((4, 1), [(4, 2), (4, 3)]),
          f"ui radar: {radar}")
    check(got["score_matmul"] == len(frames) - 1, f"ui radar: launches {got}")
    phase("ui", f"GameSession radar on the card: e2 lifted -> lifted_piece_square "
          f"{radar[-1][0]}, destinations {radar[-1][1]} (frames {radar}); on_frame p50 "
          f"{_pct(times, 50):.3f} ms (host clock); launches {got}; on {smi}")


def ui_phase(smi):
    """The UI tools and the session's radar at 1280x720 on the card, with
    every count set to 0 just before each tool's run and read just after it,
    in a temporary working directory (the tools read and write their JSON
    files there). Returns (the path's counts, B1's max error)."""
    t0 = time.perf_counter()
    camera = SynthCamera(UI_CORNERS, frame_size=(UI_HEIGHT, UI_WIDTH))
    occ = initial_occupancy()
    lifted = occ.copy()
    lifted[4, 1] = False
    # The e2 pawn dark in the sensitivity tuner's frames: its change gate
    # passes a light piece lifted off a light square unseen (Queue C 5).
    colors = np.empty((8, 8), object)
    colors[4, 1] = DARK_PIECE
    start = ui_renders(camera, occ, 50)
    dark = (ui_renders(camera, occ, 51, piece_colors=colors),
            ui_renders(camera, lifted, 52, piece_colors=colors))
    phase("ui", f"rendered {3 * UI_RENDERS} frames of {UI_WIDTH}x{UI_HEIGHT} in "
          f"{time.perf_counter() - t0:.1f} s")
    config = {"corners": UI_CORNERS.tolist(), "player_color": "white",
              "orientation_flipped": False, "grid_lines_x": None, "grid_lines_y": None}
    launches = collections.Counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            err = ui_piece_detector(start, config, _occ_set(occ), launches, smi)
            err = max(err, ui_sensitivity(dark, config, launches, smi))
            ui_colors(start[0], launches, smi)
            ui_enhance_demo([start[i % UI_RENDERS] for i in range(UI_ENHANCE_FRAMES)], launches,
                            smi)
            ui_calibrator(start, launches, smi)
            ui_radar(camera, config, launches, smi)
        finally:
            os.chdir(cwd)
    counts = {name: launches[name] for name in COUNTERS}
    phase("ui", f"kernel launches on this path: {counts}")
    return counts, err


# ---------------------------------------------------------------------------
# The port's parity with the JAX package: the change detector switched off,
# the enhancer's backend seam, PieceDetectorModel, the host resampler, the
# split-row fleet and the enhanced-path kernel ablation.
# ---------------------------------------------------------------------------

CHANGE_FIELDS = {"change_intensity": np.int32, "change_pct": np.float32,
                 "change_z_peak": np.float32}
# Queue C 7: after the sharpen a pixel may differ by up to 9 levels on at
# most 1e-3 of the pixels; the bilateral alone by one level on 1e-4.
ENHANCE_MAX_DIFF, ENHANCE_FRACTION = 9, 1e-3
BILATERAL_MAX_DIFF, BILATERAL_FRACTION = 1, 1e-4
SPLIT_SHAPE, SPLIT_STREAMS, SPLIT_SLOTS = (3, 2), 6, 3
# The production B2-B4 at 980^2, µs a call, as PERF.md's kernel table
# recorded them before the ablation instantiations were added (chip_smoke's
# kernel phase, NVIDIA H100 80GB HBM3, 700 W). Those instantiations leave
# the production ones' code as it was.
RECORDED_US = {"bilateral": 29.8, "clahe_hist": 4.1, "clahe_apply": 3.9}
MOVED_SHARE = 0.15


def _within(a, b, max_diff, fraction, what):
    d = (a.to(torch.int32) - b.to(torch.int32)).abs()
    share = (d > 0).float().mean().item()
    check(int(d.max()) <= max_diff and share <= fraction,
          f"{what}: max diff {int(d.max())}, {share:.3g} of pixels differ")
    return int(d.max()), share


def change_off_phase(g, frames, smi):
    """8 streams with with_change_detector=False beside the default tick on
    the same frames: every other output bit-equal (the occupancy among
    them), the change fields zeros of i32/f32/f32, B1 once a tick; then ms
    a tick of both in turns (default, off, off, default). Returns the
    path's counts."""
    sets, initial, _ = frames
    n = 8
    refs = np.stack([initial[s % 3] for s in range(n)])
    frame_sets = [np.stack(fs[:n]) for fs in sets]
    masks = _all_masks(n)
    launches = collections.Counter()
    pipes = {"default": tms.MultiStreamPipeline(g, n, device=DEVICE),
             "no change detector": tms.MultiStreamPipeline(g, n, with_change_detector=False,
                                                           device=DEVICE)}
    states, hosts = {}, {}
    for label, ms in pipes.items():
        with counted(launches):
            st = ms.capture_reference(ms.init_state(), refs)
        with counted(launches) as got:
            st, out = ms.step(st, frame_sets[0], s2c_masks=masks)
        check_tick(got, n, f"{label} 8 streams")
        states[label], hosts[label] = st, tms.outputs_to_numpy(out)
    a, b = hosts["default"], hosts["no change detector"]
    for f in tp.StepOutputs._fields:
        x, y = getattr(b.step, f), getattr(a.step, f)
        if f in CHANGE_FIELDS:
            check(x.dtype == CHANGE_FIELDS[f] and not x.any(), f"change detector off: {f} not 0")
        else:
            check(x.dtype == y.dtype and np.array_equal(x, y),
                  f"change detector off: {f} differs from the default tick")
    for f in a.noise._fields:
        check(np.array_equal(getattr(a.noise, f), getattr(b.noise, f)),
              f"change detector off: noise {f} differs")
    walls = collections.defaultdict(list)
    for label in ("default", "no change detector", "no change detector", "default"):
        with counted(launches):
            wall, states[label] = mesh_tick_ms(pipes[label], states[label], frame_sets, masks)
        walls[label].append(wall)
    text = "; ".join(f"{k} {np.mean(v):.3f} ms/tick ({', '.join(f'{w:.3f}' for w in v)})"
                     for k, v in walls.items())
    phase("streams", f"8 streams with_change_detector=False: occupancy and every other output "
          f"bit-equal to the default tick, change fields zeros; in turns: {text}; on {smi}")
    return {name: launches[name] for name in COUNTERS}


def backend_seam_phase(pipe, frame, smi):
    """The enhancer's backend seam on the card at the 1080p board:
    bilateral_backend="plain" within Queue C 7's limits of "kernel" (the
    bilateral alone and the whole enhancement), the clahe(backend=) seam
    the same way, "kernel" on a CPU tensor raising, and an enhanced
    pipeline on "plain" giving the kernel pipeline's bool/i32 outputs
    without a B2 launch."""
    board = warp_ops.frame_to_board(on_card(frame), pipe.consts.dg).movedim(-1, -3).contiguous()
    lit = correct_lighting(board)
    got = {b: tenhancer.bilateral(lit, b) for b in ("kernel", "plain")}
    bil = _within(got["plain"], got["kernel"], BILATERAL_MAX_DIFF, BILATERAL_FRACTION,
                  "bilateral plain vs kernel")
    whole = {b: tenhancer.enhance_planar(board, pipe.enhancer_profile, bilateral_backend=b)
             for b in ("kernel", "plain")}
    enh = _within(whole["plain"], whole["kernel"], ENHANCE_MAX_DIFF, ENHANCE_FRACTION,
                  "enhance_planar plain vs kernel")
    lab_l = planar_bgr2lab(board)[0].contiguous()
    check(torch.equal(tenh.clahe(lab_l, backend="plain"), tenh.clahe(lab_l, backend="kernel")),
          "clahe plain != kernel on the card")
    for what, call in (("bilateral", lambda: tenhancer.bilateral(lit.cpu(), "kernel")),
                       ("clahe", lambda: tenh.clahe(lab_l.cpu(), backend="kernel"))):
        try:
            call()
        except ValueError as e:
            check("cpu" in str(e), f"{what}: 'kernel' on a CPU tensor raised {e}")
        else:
            raise RuntimeError(f"{what}: backend='kernel' on a CPU tensor did not raise")
    g = pipe.geometry
    outs = {}
    for b in ("kernel", "plain"):
        p = tp.VisionPipeline(g, with_enhancer=True, bilateral_backend=b, device=DEVICE)
        st = p.capture_reference(p.init_state(), frame)
        before = kb.bilateral_planar.launches
        st, o = p.step(st, frame)
        outs[b] = tp.outputs_to_numpy(o)
        launched = kb.bilateral_planar.launches - before
        check(launched == (1 if b == "kernel" else 0), f"{b} pipeline: {launched} B2 launches")
    for f in EXACT_FIELDS:
        check(np.array_equal(getattr(outs["plain"], f), getattr(outs["kernel"], f)),
              f"enhanced pipeline bilateral_backend='plain': {f} differs from 'kernel'")
    ms_plain = cuda_ms(lambda: tenhancer.bilateral(lit, "plain"), 5)
    ms_kernel = cuda_ms(lambda: tenhancer.bilateral(lit, "kernel"), 20)
    phase("enhanced", f"backend seam at {tuple(board.shape)}: bilateral 'plain' vs 'kernel' max "
          f"diff {bil[0]} on {bil[1]:.3g} of pixels, enhance_planar {enh[0]} on {enh[1]:.3g} "
          "(Queue C 7's limits), clahe 'plain' == 'kernel', 'kernel' on a CPU tensor raises, "
          "the 'plain' pipeline's bool/i32 outputs equal the kernel pipeline's with no B2 "
          f"launch; bilateral plain {ms_plain:.3f} ms vs kernel {ms_kernel:.4f} ms a call "
          f"(CUDA events); on {smi}")


def piece_model_phase(corners, camera, smi):
    """PieceDetectorModel on the card (exact Hough, as the JAX model):
    calibrate_reference on the start position's squares, then
    get_occupied_squares on the rendered e2e4 frame equals the truth. The
    moving pawn is rendered dark, as the ui phase's: a light pawn on light
    e2 and e4 passes the reference's delta gate unseen (Queue C 5), and
    after calibrate_reference the model reports its cache wherever the
    gate stays shut."""
    start, moved = _boards("e2e4")
    g = BoardGeometry.from_calibration(corners, display_size=(WIDTH, HEIGHT))
    pipe = tp.VisionPipeline(g, device=DEVICE)  # its preprocess gives the squares
    squares = []
    for i, (board, pawn) in enumerate(((start, (4, 1)), (moved, (4, 3)))):
        occ, colors, radii = board_render_maps(board)
        colors[pawn] = DARK_PIECE
        frame = camera.render(occ, np.random.default_rng((22, i)), colors, radii)
        squares.append(pipe.preprocess(on_card(frame))[0])
    model = PieceDetectorModel(g.squares.heights, g.squares.widths, device=DEVICE)
    t0 = time.perf_counter()
    model.calibrate_reference(squares[0])
    got = model.get_occupied_squares(squares[1])
    wall = (time.perf_counter() - t0) * 1e3
    truth = _occ_set(occupancy_of(moved))
    check(got == truth, f"PieceDetectorModel: {sorted(got ^ truth)} differ from the truth")
    phase("footage", f"PieceDetectorModel on the card: calibrate_reference on the start "
          f"position, get_occupied_squares on e2e4 equals the truth; {wall:.1f} ms for both "
          f"(host clock, exact Hough); on {smi}")


def host_resampler_phase(pipe, frame, smi):
    """native.HostResampler built here (g++) on the 1080p board plan:
    resample_bgr bit-equal to the port's board warp on the card
    (warp_board: the gather warp run op by op), resample_gray to its cv2
    gray; to_planar_native equal to to_planar; ms a frame (host clock,
    median of 5)."""
    g = pipe.geometry
    t0 = time.perf_counter()
    host = native.HostResampler(g.warp_X, g.warp_Y, g.src_h, g.src_w)
    built = time.perf_counter() - t0
    board = pipe.warp_board(frame)
    for c, got in enumerate(host.resample_bgr(frame)):
        check(np.array_equal(got, board[..., c].reshape(-1)),
              f"HostResampler channel {c} differs from the card's board warp")
    gray = bgr2gray(torch.as_tensor(board, device=DEVICE)).cpu().numpy().reshape(-1)
    check(np.array_equal(host.resample_gray(frame), gray),
          "HostResampler gray differs from the card's board warp and gray")
    check(np.array_equal(native.to_planar_native(frame), to_planar(frame)),
          "to_planar_native != to_planar")
    ms = {}
    for label, fn in (("resample_gray", lambda: host.resample_gray(frame)),
                      ("resample_bgr", lambda: host.resample_bgr(frame)),
                      ("to_planar_native", lambda: native.to_planar_native(frame)),
                      ("warp_board on the card, D2H included", lambda: pipe.warp_board(frame))):
        ms[label] = call_ms(fn)
    phase("footage", f"HostResampler (built with the plan in {built:.2f} s) on the "
          f"{g.board_size}^2 board plan of a {WIDTH}x{HEIGHT} frame: bit-equal to the card's "
          f"board warp; ms a frame " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; on {smi}")


def split_fleet_phase(smi):
    """A fleet whose data row 1 spans two processes: 2 Gloo processes on
    cuda:0, SPLIT_SLOTS slots each, data 3 x space 2, 6 streams of 1280x720,
    two ticks (the second with square masks, which each process gives
    wrong for the rows it does not own): each owner's rows bit-equal, every
    StepOutputs and FSM field, to this process's unsharded run. Then the
    same over NCCL where the machine has two cards."""
    g, camera = dryrun_multigpu.rig((720, 1280), margin=100)
    refs, steps = dryrun_multigpu.stream_frames(camera, SPLIT_STREAMS, seed=21)
    masks = np.stack([positions_to_mask({(s % 8, 1), (s % 8, 3), (0, 0)})
                      for s in range(SPLIT_STREAMS)])
    ms = tms.MultiStreamPipeline(g, SPLIT_STREAMS, device=DEVICE)
    state = ms.capture_reference(ms.init_state(), refs)
    expected = {"rtol": 0.0, "atol": 0.0}
    for t in range(2):
        state, out = ms.step(state, steps, s2c_masks=masks if t else None)
        host = tms.outputs_to_numpy(out)
        expected.update({f"t{t}_{f}": getattr(host.step, f) for f in host.step._fields})
        expected.update({f"t{t}_noise_{f}": getattr(host.noise, f) for f in host.noise._fields})
    expected["occ"] = expected["t0_occupancy"]
    with tempfile.TemporaryDirectory() as tmp:
        frames_path, expected_path = os.path.join(tmp, "split.npz"), os.path.join(tmp, "exp.npz")
        dryrun_multigpu.save_fleet(frames_path, refs, steps, g, 100, SPLIT_SLOTS,
                                   shape=SPLIT_SHAPE, masks=masks)
        np.savez(expected_path, **expected)
        wall = fleet_launch(frames_path, expected_path, ["cuda:0", "cuda:0"], "gloo",
                            "split-row gloo fleet")
        phase("fleet", f"split-row gloo fleet: 2 processes on cuda:0, data 3 x space 2 over "
              f"{2 * SPLIT_SLOTS} slots, row 1 across the processes, {SPLIT_STREAMS} streams of "
              f"1280x720, 2 ticks: each owner's rows bit-equal to the unsharded run in every "
              f"field; {wall:.2f} s wall from launch to exit; on {smi}")
        if torch.cuda.device_count() >= 2:
            wall = fleet_launch(frames_path, expected_path, ["cuda:0", "cuda:1"], "nccl",
                                "split-row nccl fleet")
            phase("fleet", f"split-row nccl fleet: 2 processes on cuda:0 and cuda:1, "
                  f"{wall:.2f} s wall")
        else:
            phase("fleet", "split-row NCCL fleet not run: it needs a card a process and this "
                  f"machine has {torch.cuda.device_count()} (NCCL refuses two ranks on one card)")


def ablation_phase(records, smi):
    """tools/ablate_enhanced.py at 980^2 (its table lines here), then the
    production B2-B4 device times of the kernel phase beside RECORDED_US:
    a "FLAG" line where one moved by more than MOVED_SHARE."""
    args = ablate_enhanced.parse_args(["--size", "980", "--iters", "100", "--passes", "3"])
    values, unheld = ablate_enhanced.run(args)
    for name, us in values.items():
        phase("ablation", f"{name}: {us:.2f} us/call"
              + (" (unheld: events around the chain)" if name in unheld else ""))
    for group in ("hist", "apply"):
        phase("ablation", f"{group}: the empty kernel's launch {values['empty/launch']:.2f} us is "
              f"{values['empty/launch'] / values[f'{group}/full']:.0%} of its full "
              f"{values[f'{group}/full']:.2f} us")
    ratios = []
    for cut in ("full", "notable"):
        rnd, board = values[f"bilateral/{cut}@random"], values[f"bilateral/{cut}@board"]
        ratios.append(f"{cut} {rnd:.2f} / {board:.2f} us ({rnd / board:.3f}x)")
    phase("ablation", f"bilateral on random u8 / a rendered board: {', '.join(ratios)}")
    for rec in records:
        if rec["name"] in RECORDED_US:
            us, was = rec["ms"] * 1e3, RECORDED_US[rec["name"]]
            moved = abs(us - was) > MOVED_SHARE * was
            phase("ablation", f"{'FLAG: ' if moved else ''}production {rec['name']} "
                  f"{us:.2f} us/call (kernel phase) beside PERF.md's recorded {was} us "
                  f"({us / was:.3f}x); on {smi}")
    print(json.dumps({"ablation": values, "unheld": unheld, "card": smi}), flush=True)


def main():
    t_start = time.perf_counter()

    def elapsed(what):
        phase("time", f"{what} done at {time.perf_counter() - t_start:.0f} s")

    _, smi = device_phase()
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
    records[0]["max_abs_err"] = max(records[0]["max_abs_err"], b1_plans_phase(smi))
    records += enhancement_kernels_phase(pipe, frame, smi)
    batched_enhancement_phase(pipe, camera, smi)
    whole_frame_phase(frame, smi)
    records.append(resample_phase(smi))
    elapsed("kernels")

    plain = run_path("plain", False, corners, camera, rng, CHUNK, smi)
    check(plain["score_matmul"] > 0, "the plain path never launched score_matmul")
    check(sm.score_matmul.last_path == "tma",
          f"the plain path's score_matmul took the {sm.score_matmul.last_path} kernel")
    check(not any(plain[k] for k in ENHANCEMENT),
          "the plain path launched an enhancement kernel")
    check(plain["resample"] > 0, "the plain path's planar frames never launched the resample")
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
    backend_seam_phase(pipe, frame, smi)
    elapsed("plain and enhanced paths")
    stages_phase(pipe, frame, camera, g, smi)
    elapsed("stages")
    bench_counts = bench_phase(smi)
    elapsed("bench")
    exact_phase(corners, camera, rng, smi)
    elapsed("exact path")

    streams, b1_wide_err, stream_frames = streams_phase(corners, camera, g, pipe, smi)
    missing = [k for k in COUNTERS if k != "clahe_hist" and streams[k] == 0]
    check(not missing, f"the streams path never launched {missing}")
    check(streams["clahe_hist"] == 0, "the streams path launched the histogram-only B3")
    records[0]["max_abs_err"] = max(records[0]["max_abs_err"], b1_wide_err)
    for wrapper, count in change_off_phase(g, stream_frames, smi).items():
        streams[wrapper] += count
    elapsed("streams path")

    t0 = time.perf_counter()
    mesh = mesh_phase(corners, g, stream_frames, smi)
    del stream_frames
    missing = [k for k in COUNTERS if k != "clahe_hist" and mesh[k] == 0]
    check(not missing, f"the mesh path never launched {missing}")
    check(mesh["clahe_hist"] == 0, "the mesh path launched the histogram-only B3")
    phase("time", f"mesh phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fleet_phase(smi)
    split_fleet_phase(smi)
    phase("time", f"fleet phase took {time.perf_counter() - t0:.1f} s")
    elapsed("mesh and fleet paths")

    footage = footage_phase(corners, camera, smi)
    missing = [k for k in COUNTERS if k != "clahe_hist" and footage[k] == 0]
    check(not missing, f"the footage path never launched {missing}")
    check(footage["clahe_hist"] == 0, "the footage path launched the histogram-only B3")
    piece_model_phase(corners, camera, smi)
    host_resampler_phase(pipe, frame, smi)
    elapsed("footage path")

    live = live_phase(smi)
    missing = [k for k in COUNTERS if k != "clahe_hist" and live[k] == 0]
    check(not missing, f"the live path never launched {missing}")
    check(live["clahe_hist"] == 0, "the live path launched the histogram-only B3")
    elapsed("live path")

    ui, ui_err = ui_phase(smi)
    missing = [k for k in COUNTERS if k != "clahe_hist" and ui[k] == 0]
    check(not missing, f"the ui path never launched {missing}")
    check(ui["clahe_hist"] == 0, "the ui path launched the histogram-only B3")
    records[0]["max_abs_err"] = max(records[0]["max_abs_err"], ui_err)
    elapsed("ui path")
    ablation_phase(records, smi)
    elapsed("ablation")

    for rec in records:
        w = PATH_WRAPPER.get(rec["name"], rec["name"])
        rec["launches"] = (plain[w] + enhanced[w] + streams[w] + mesh[w] + footage[w] + live[w]
                           + ui[w] + bench_counts[w])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in records]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
