"""Where one pipeline step's time goes on a CUDA card.

Drives ``VisionPipeline.step`` (or, with ``--streams N``, one tick of
``MultiStreamPipeline.step`` for N streams) on rendered frames of the
benchmark's board layout (full smart-scan set, chained state) and prints,
per step:

- the host time to pack the frame(s) with the flags and start the upload
  (as the step does it: a host HWC frame is taken planar on the card by a
  single-stream step and kept HWC by a shared-geometry tick), and the host
  time to enqueue the step's device work (no upload);
- under ``torch.profiler`` (``utils.profiling.device_trace``): the wall
  time, the device busy time and its share of the wall, the device kernels
  and copies, the host syncs (the exact backend's hysteresis readbacks);
  then the device time per source file of the port (the innermost frame of
  the port's package around each record's launch, as the JAX tool gives
  each op's source file) and the top kernels with their source.

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
from chessboard_vision_tpu_torch.models.pipeline import VisionPipeline, upload
from chessboard_vision_tpu_torch.ops.canny import canny
from chessboard_vision_tpu_torch.ops.layout import to_planar
from chessboard_vision_tpu_torch.parallel.multistream import MultiStreamPipeline
from chessboard_vision_tpu_torch.tools.synth import SynthCamera, bench_corners, initial_occupancy
from chessboard_vision_tpu_torch.utils.profiling import device_op_rows, device_trace, frame_path


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
        flags = pipe._flags((), masks)

        def step(state, i):
            return pipe.step(state, frames[i % 4], s2c_masks=masks)

        def pack(i):
            return upload(frames[i % 4], flags, pipe.device)

        def enqueue(state, uploaded):
            return pipe._tick(state, *uploaded)
    else:
        pipe = VisionPipeline(g, **kw)
        s2c = {(f, r) for f in range(8) for r in range(8)}

        def step(state, i):
            return pipe.step(state, frames[i % 4], squares_to_check=s2c)

        def pack(i):
            return pipe._upload(frames[i % 4], np.ones(64, bool), (True, False))

        def enqueue(state, uploaded):
            frame, mask, flags = uploaded
            return pipe._step_impl(state, frame, mask, flags[0], flags[1])
    state = pipe.capture_reference(pipe.init_state(), frames[0])
    for i in range(10):  # warm up the allocator and the kernel build
        state, _ = step(state, i)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for i in range(n):
        uploaded = pack(i)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(n):
        state, _ = enqueue(state, uploaded)
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    backend = pipe.pipe.hough_backend if args.streams else pipe.hough_backend
    what = (f"{w}x{h}{' enhanced' if args.enhance else ''}, {backend} Hough, "
            f"{'planar' if args.planar else 'HWC'} frames")
    if args.streams:
        what += f", {args.streams} streams a tick"
    print(f"{what}: host pack+upload {1e3 * (t1 - t0) / n:.3f} ms, step enqueue "
          f"{1e3 * (t2 - t1) / n:.3f} ms, enqueue+drain {1e3 * (t3 - t1) / n:.3f} ms per step")

    syncs = canny.host_syncs
    with tempfile.TemporaryDirectory(prefix="profile_step_") as tdir:
        with device_trace(tdir):
            t0 = time.perf_counter()
            for i in range(n):
                state, _ = step(state, i)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / n
        rows = device_op_rows(tdir)
    busy_ms = sum(ms for _, _, ms in rows) / n
    print(f"profiled {n} steps: wall {wall_ms:.3f} ms/step, device busy {busy_ms:.3f} "
          f"ms/step ({100 * busy_ms / wall_ms:.1f}% of wall), {len(rows) / n:.0f} device "
          f"kernels+copies/step, {(canny.host_syncs - syncs) / n:.1f} host syncs/step")
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
