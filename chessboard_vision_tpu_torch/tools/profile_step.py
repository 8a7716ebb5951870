"""Where one pipeline step's time goes on a CUDA card.

Drives ``VisionPipeline.step`` (or, with ``--streams N``, one tick of
``MultiStreamPipeline.step`` for N streams) on rendered frames of the
benchmark's board layout (full smart-scan set, chained state) and prints,
per step:

- the host time of the step's spans (``utils.profiling``'s call table):
  ``pipeline.upload`` (the frame(s) packed with the flags into a
  page-locked buffer and the copy started: a host HWC frame is taken
  planar on the card by a single-stream step and kept HWC by a
  shared-geometry tick), ``pipeline.enqueue`` (the step's device work
  enqueued) and the whole ``pipeline.step``, over steps with no profiler
  and over the profiled steps, with the CUDA graph captures and replays
  of those steps (the counters ``pipeline.graph_captures`` and
  ``pipeline.graph_replays``: a single-stream conv step without the
  enhancer replays one graph from its third call, models/pipeline.py);
- under ``torch.profiler`` (``utils.profiling.device_trace``): the wall
  time, the device busy time and its share of the wall, the device kernels
  and copies, the host syncs (the exact backend's hysteresis readbacks);
  each span's host and self time and the device's idle time inside its
  ranges (what the host was doing while the card waited); then the device
  time per source file of the port (the innermost frame of the port's
  package around each record's launch, as the JAX tool gives each op's
  source file) and the top kernels with their source. A replayed graph's
  records all come from its one launch, in utils/graphs.py.

The card's name and power limit (nvidia-smi) head the output.

Run: python -m chessboard_vision_tpu_torch.tools.profile_step [--steps 20] [--enhance]
[--streams N] [--hough-backend conv|exact] [--planar]
"""

from __future__ import annotations

import argparse
import subprocess
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from chessboard_vision_tpu_torch.geometry import BoardGeometry
from chessboard_vision_tpu_torch.models.pipeline import VisionPipeline
from chessboard_vision_tpu_torch.ops.canny import canny
from chessboard_vision_tpu_torch.ops.layout import to_planar
from chessboard_vision_tpu_torch.parallel.multistream import MultiStreamPipeline
from chessboard_vision_tpu_torch.tools.synth import SynthCamera, bench_corners, initial_occupancy
from chessboard_vision_tpu_torch.utils.profiling import (
    clear,
    device_op_rows,
    device_trace,
    frame_path,
    recorded_calls,
    span_rows,
)

STEP_SPANS = ("pipeline.upload", "pipeline.enqueue", "pipeline.step")
GRAPH_COUNTERS = ("pipeline.graph_captures", "pipeline.graph_replays")


def step_span_means() -> str:
    """The mean host ms a step of each of STEP_SPANS, over the steps the call
    table holds, and the sum of each of GRAPH_COUNTERS over them."""
    calls = [c for c in recorded_calls() if c.root == "pipeline.step"]
    return ", ".join([f"{name} {np.mean([c.ms(name) for c in calls]):.3f}" for name in STEP_SPANS]
                     + [f"{name} {sum(c.counts.get(name, 0) for c in calls)}"
                        for name in GRAPH_COUNTERS])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--steps", type=int, default=20, help="steps per measurement")
    ap.add_argument("--top", type=int, default=12, help="kernels to list")
    ap.add_argument("--enhance", action="store_true", help="profile the enhanced pipeline")
    ap.add_argument("--streams", type=int, default=0,
                    help="profile one N-stream tick (MultiStreamPipeline) instead of a step")
    ap.add_argument("--hough-backend", default="auto", choices=("auto", "conv", "exact"),
                    help="circle detector (auto: conv on the card)")
    ap.add_argument("--planar", action="store_true",
                    help="hand the frames over planar (the matmul resample) instead of HWC")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    h, w, n = args.height, args.width, args.steps
    corners = bench_corners(h, w)
    g = BoardGeometry.from_calibration(corners, display_size=(w, h))
    cam = SynthCamera(corners, frame_size=(h, w), board_px=g.board_size)
    rng = np.random.default_rng(0)
    frames = [cam.render(initial_occupancy(), rng) for _ in range(4)]
    if args.planar:
        frames = [to_planar(f) for f in frames]
    kw = dict(with_enhancer=args.enhance, hough_backend=args.hough_backend, device="cuda")
    if args.streams:
        k = args.streams
        pipe = MultiStreamPipeline(g, k, **kw)
        frames = [np.stack([frames[(i + s) % 4] for s in range(k)]) for i in range(4)]
        masks = np.ones((k, 64), bool)

        def step(state, i):
            return pipe.step(state, frames[i % 4], s2c_masks=masks)
    else:
        pipe = VisionPipeline(g, **kw)
        s2c = {(f, r) for f in range(8) for r in range(8)}

        def step(state, i):
            return pipe.step(state, frames[i % 4], squares_to_check=s2c)
    state = pipe.capture_reference(pipe.init_state(), frames[0])
    for i in range(10):  # warm up the allocator and the kernel build
        state, _ = step(state, i)
    torch.cuda.synchronize()

    clear()
    for i in range(n):
        state, _ = step(state, i)
    torch.cuda.synchronize()
    backend = pipe.pipe.hough_backend if args.streams else pipe.hough_backend
    what = (f"{w}x{h}{' enhanced' if args.enhance else ''}, {backend} Hough, "
            f"{'planar' if args.planar else 'HWC'} frames")
    if args.streams:
        what += f", {args.streams} streams a tick"
    print(f"{what}: host ms a step, no profiler: {step_span_means()}")

    syncs = canny.host_syncs
    with tempfile.TemporaryDirectory(prefix="profile_step_") as tdir:
        clear()
        with device_trace(tdir):
            t0 = time.perf_counter()
            for i in range(n):
                state, _ = step(state, i)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / n
        rows = device_op_rows(tdir)
        spans = span_rows(tdir, per=n)
    busy_ms = sum(ms for _, _, ms in rows) / n
    print(f"profiled {n} steps: wall {wall_ms:.3f} ms/step, device busy {busy_ms:.3f} "
          f"ms/step ({100 * busy_ms / wall_ms:.1f}% of wall), {len(rows) / n:.0f} device "
          f"kernels+copies/step, {(canny.host_syncs - syncs) / n:.1f} host syncs/step; "
          f"host ms a step: {step_span_means()}")
    print("spans in the trace (ms/step): host, self, device idle inside")
    for name, r in spans.items():
        print(f"  {r.ms:8.3f}  {r.self_ms:8.3f}  {r.idle_ms:8.3f}  {name}")
    per_file, per_op, count = defaultdict(float), defaultdict(float), defaultdict(int)
    for name, frames, ms in rows:
        source = frames[0] if frames else "?"
        per_file[frame_path(source)] += ms / n
        per_op[name, source] += ms / n
        count[name, source] += 1
    print("per source file of the port (ms/step):")
    for source, ms in sorted(per_file.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:8.4f}  {source}")
    print(f"top {args.top} kernels (ms/step):")
    for key, ms in sorted(per_op.items(), key=lambda kv: -kv[1])[: args.top]:
        print(f"  {ms:8.4f}  {count[key] / n:6.1f}/step  {key[0][:70]:<70} {key[1]}")


if __name__ == "__main__":
    main()
