"""Dry run of the port's stream meshes, and one process of a fleet.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip`` and
of its tests' fleet worker. Two modes:

- ``python -m chessboard_vision_tpu_torch.tools.dryrun_multigpu
  [--devices cuda:0,cuda:0,...]``: ``dryrun(devices)`` runs a capture and a
  tick of rendered 320x240 frames (tools/synth.py) on the dp mesh over the
  slots, on the dp x sp mesh (n/2 x 2) and on the enhanced dp mesh, and
  holds every stream's occupancy, visual_changes and radius bit-equal to
  one single-device VisionPipeline given that stream's frames. The default
  slots are 8 over the cards of this process (``cuda:{i % cards}``);
  ``--devices cpu`` names eight CPU slots.
- ``--fleet-worker RANK WORLD PORT FRAMES.npz EXPECTED.npz --device D
  [--backend B]``: one process of a fleet of WORLD processes on
  localhost:PORT. It loads only its own streams' frames from FRAMES.npz
  (``save_fleet``: no JAX and no cv2 needed), joins the group through
  ``init_distributed`` (False is a failure here), builds the global mesh
  over its slots (all on D), runs a capture and a tick of its streams, and
  checks its occupancy against its rows of EXPECTED.npz ("occ", (N, 64)),
  its outputs' global rows, and the fleet's per-square sum of occupancy
  (``fleet_sum``) against the expected one. It prints
  ``FLEET-OK rank=R`` and exits 0, or exits non-zero.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from chessboard_vision_tpu_torch.geometry import BoardGeometry
from chessboard_vision_tpu_torch.models import pipeline as tp
from chessboard_vision_tpu_torch.ops.layout import to_planar
from chessboard_vision_tpu_torch.parallel import distributed as pdist
from chessboard_vision_tpu_torch.parallel import multistream as tms
from chessboard_vision_tpu_torch.parallel.mesh import make_mesh
from chessboard_vision_tpu_torch.tools.synth import SynthCamera, bench_corners, initial_occupancy

FRAME_SIZE = (240, 320)  # (H, W)
MARGIN = 80  # a 160 px board of 20 px squares
PROFILE = {"contrast": 1.05, "brightness": 3}
PARITY_FIELDS = ("occupancy", "visual_changes", "radius")


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def rig(frame_size=FRAME_SIZE, margin=MARGIN):
    """(geometry, camera) of the benchmark's board layout at ``frame_size``."""
    h, w = frame_size
    corners = bench_corners(h, w)
    g = BoardGeometry.from_calibration(corners, display_size=(w, h), margin=margin)
    return g, SynthCamera(corners, frame_size=frame_size, board_px=g.board_size)


def stream_frames(camera, n: int, seed: int):
    """(reference, step) planar frames (n, 3, H, W) u8: stream i's pawn of
    file i % 8 leaves its square, so every stream sees its own board."""
    rng = np.random.default_rng(seed)
    refs, steps = [], []
    for i in range(n):
        occ = initial_occupancy()
        refs.append(to_planar(camera.render(occ, rng)))
        occ[i % 8, 1] = False
        steps.append(to_planar(camera.render(occ, rng)))
    return np.stack(refs), np.stack(steps)


def assert_stream_parity(out, refs, steps, g, device, label, **pipe_kw):
    """Every stream of a meshed tick bit-equal to a single-device
    VisionPipeline run on that stream's frames (occupancy, visual_changes,
    radius), as the JAX dry run holds its sharded tick."""
    host = tms.outputs_to_numpy(out)
    pipe = tp.VisionPipeline(g, device=device, **pipe_kw)
    for i in range(len(refs)):
        st = pipe.capture_reference(pipe.init_state(), refs[i])
        st, o = pipe.step(st, steps[i])
        o = tp.outputs_to_numpy(o)
        for f in PARITY_FIELDS:
            check(np.array_equal(getattr(host.step, f)[i], getattr(o, f)),
                  f"{label} stream {i} {f}: meshed != single-device pipeline")
    print(f"dryrun_multigpu[{label}]: value parity OK (occupancy/visual_changes/radius "
          f"bit-equal per stream)", flush=True)


def dryrun(devices, seed: int = 0) -> None:
    """The dp, dp x sp and enhanced dp meshes over the slots ``devices``
    (an even count for dp x sp), each a capture and a tick; raises on the
    first stream that differs from its single-device pipeline."""
    n = len(devices)
    g, camera = rig()
    refs, steps = stream_frames(camera, n, seed)
    meshes = [("dp", make_mesh(n, devices=devices), n, {})]
    if n % 2 == 0:
        meshes.append(("dp x sp", make_mesh(n, ("data", "space"), (n // 2, 2), devices=devices),
                       n // 2, {}))
    meshes.append(("dp enhanced", meshes[0][1], n,
                   {"with_enhancer": True, "enhancer_profile": PROFILE}))
    for label, mesh, streams, kw in meshes:
        ms = tms.MultiStreamPipeline(g, streams, mesh=mesh, **kw)
        state = ms.capture_reference(ms.init_state(), refs[:streams])
        state, out = ms.step(state, steps[:streams])
        check(tuple(out.step.occupancy.shape) == (streams, 64), f"{label}: occupancy shape")
        slots = [str(d) for d in mesh.devices.flat]
        print(f"dryrun_multigpu[{label}]: mesh {mesh.shape} on {slots}, {streams} streams OK",
              flush=True)
        assert_stream_parity(out, refs[:streams], steps[:streams], g, ms.device, label, **kw)


def save_fleet(path, refs, steps, g: BoardGeometry, margin: int, slots: int) -> None:
    """A fleet's workload for ``fleet_worker``: each stream's reference and
    step frames under keys of their own (a worker loads its streams alone),
    the rig's corners, capture size and margin, the slots a process."""
    arrays = {f"ref_{i}": r for i, r in enumerate(refs)}
    arrays.update({f"step_{i}": s for i, s in enumerate(steps)})
    np.savez(path, corners=g.src_corners, display_size=np.array([g.src_w, g.src_h]),
             margin=margin, slots=slots, n_streams=len(refs), **arrays)


def fleet_worker(rank: int, world: int, port: int, frames_path: str, expected_path: str,
                 device: str, backend: str = "auto") -> None:
    """One process of the fleet (module docstring); raises on any failure."""
    with np.load(frames_path) as z:
        n, slots = int(z["n_streams"]), int(z["slots"])
        mine = range(rank * n // world, (rank + 1) * n // world)
        refs = np.stack([z[f"ref_{i}"] for i in mine])
        steps = np.stack([z[f"step_{i}"] for i in mine])
        g = BoardGeometry.from_calibration(z["corners"], display_size=tuple(z["display_size"]),
                                           margin=int(z["margin"]))
    check(pdist.init_distributed(f"localhost:{port}", world, rank, backend=backend),
          f"fleet worker {rank}: init_distributed returned False")
    try:
        mesh = pdist.global_stream_mesh(local_devices=[device] * slots)
        local = pdist.distribute_local_streams(mesh, steps)
        check(local.streams == mine and local.global_shape == (n,) + steps.shape[1:],
              f"rank {rank}: streams {local.streams} of {local.global_shape}, want {mine}")
        ms = tms.MultiStreamPipeline(g, n, mesh=mesh)
        state = ms.capture_reference(ms.init_state(), refs)
        state, out = ms.step(state, local.frames)
        expected = np.load(expected_path)["occ"]
        occ = tms.outputs_to_numpy(out).step.occupancy
        check(out.streams == mine, f"rank {rank}: outputs hold streams {out.streams}, want {mine}")
        check(np.array_equal(occ, expected[mine.start:mine.stop]),
              f"rank {rank}: occupancy of streams {mine.start}:{mine.stop} differs from the "
              "expected rows")
        total = pdist.fleet_sum(out.step.occupancy.to(torch.int32)).cpu().numpy()
        check(np.array_equal(total, expected.sum(axis=0)),
              f"rank {rank}: fleet sum of occupancy {total} != expected {expected.sum(axis=0)}")
        print(f"FLEET-OK rank={rank} streams={mine.start}:{mine.stop} of {n} on "
              f"{len(ms.slots)} slots ({device}, {torch.distributed.get_backend()}); fleet "
              f"occupancy sum {int(total.sum())}", flush=True)
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", default=None,
                    help="comma-separated slots (default: 8 over this process's cards; "
                         "'cpu' for 8 CPU slots)")
    ap.add_argument("--fleet-worker", nargs=5, metavar=("RANK", "WORLD", "PORT", "FRAMES",
                                                        "EXPECTED"))
    ap.add_argument("--device", default="cuda", help="the fleet worker's slots' device")
    ap.add_argument("--backend", default="auto", help="the fleet's backend: auto, gloo, nccl")
    args = ap.parse_args(argv)
    if args.fleet_worker:
        rank, world, port, frames, expected = args.fleet_worker
        fleet_worker(int(rank), int(world), int(port), frames, expected, args.device,
                     args.backend)
        return 0
    if args.devices == "cpu":
        devices = ["cpu"] * 8
    elif args.devices:
        devices = args.devices.split(",")
    else:
        cards = make_mesh().size  # raises without a card: the CPU is only taken when named
        devices = [f"cuda:{i % cards}" for i in range(8)]
    dryrun(devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
