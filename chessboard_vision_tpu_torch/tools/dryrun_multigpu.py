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
  localhost:PORT. It joins the group through ``init_distributed`` (False
  is a failure here), builds the global mesh over its slots (all on D; 1-D,
  or of the shape FRAMES.npz names), loads from FRAMES.npz (``save_fleet``:
  no JAX and no cv2 needed) the frames of the data rows it holds a slot of,
  runs a capture and a tick (and, where FRAMES.npz has square masks, a
  second tick with them; a process gives wrong masks for the rows it does
  not own, which the owner's must override), and checks the rows it owns:
  occupancy against EXPECTED.npz's "occ" (N, 64), each "t<tick>_<field>"
  array there too (StepOutputs fields, "noise_<field>" for the FSM's;
  floats within its "rtol"/"atol", the rest exactly), its outputs' global
  rows, and the fleet's per-square sum of occupancy (``fleet_sum``, each
  stream counted by its owner) against the expected one. It prints
  ``FLEET-OK rank=R streams=A:B of N`` (its owned rows) and exits 0, or
  exits non-zero.
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
from chessboard_vision_tpu_torch.parallel.mesh import (
    local_rows,
    make_mesh,
    stream_square_sharding,
)
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


def save_fleet(path, refs, steps, g: BoardGeometry, margin: int, slots: int,
               shape=None, masks=None) -> None:
    """A fleet's workload for ``fleet_worker``: each stream's reference and
    step frames under keys of their own (a worker loads its streams alone),
    the rig's corners, capture size and margin, the slots a process, and
    optionally the global mesh's (data, space) shape and (N, 64) square
    masks for a second tick."""
    arrays = {f"ref_{i}": r for i, r in enumerate(refs)}
    arrays.update({f"step_{i}": s for i, s in enumerate(steps)})
    if shape is not None:
        arrays["shape"] = np.asarray(shape)
    if masks is not None:
        arrays["masks"] = np.asarray(masks, bool)
    np.savez(path, corners=g.src_corners, display_size=np.array([g.src_w, g.src_h]),
             margin=margin, slots=slots, n_streams=len(refs), **arrays)


def _check_expected(expected, tick: int, out, rows: range, rank: int) -> int:
    """Every "t<tick>_..." array of EXPECTED.npz against this rank's owned
    rows of the tick's outputs; returns how many were checked."""
    host = tms.outputs_to_numpy(out)
    rtol, atol = float(expected.get("rtol", 0.0)), float(expected.get("atol", 0.0))
    checked = 0
    for key in expected.files:
        if not key.startswith(f"t{tick}_"):
            continue
        name = key[len(f"t{tick}_"):]
        part, field = ((host.noise, name[len("noise_"):]) if name.startswith("noise_")
                       else (host.step, name))
        got, want = getattr(part, field), expected[key][rows.start:rows.stop]
        if np.issubdtype(want.dtype, np.floating):
            ok = np.allclose(got, want, rtol=rtol, atol=atol)
        else:
            ok = np.array_equal(got, want)
        check(ok, f"rank {rank}: tick {tick} {name} of streams {rows.start}:{rows.stop} "
              "differs from the expected rows")
        checked += 1
    return checked


def fleet_worker(rank: int, world: int, port: int, frames_path: str, expected_path: str,
                 device: str, backend: str = "auto") -> None:
    """One process of the fleet (module docstring); raises on any failure."""
    with np.load(frames_path) as z:
        n, slots = int(z["n_streams"]), int(z["slots"])
        shape = tuple(int(v) for v in z["shape"]) if "shape" in z else None
        masks = z["masks"] if "masks" in z else None
        g = BoardGeometry.from_calibration(z["corners"], display_size=tuple(z["display_size"]),
                                           margin=int(z["margin"]))
    check(pdist.init_distributed(f"localhost:{port}", world, rank, backend=backend),
          f"fleet worker {rank}: init_distributed returned False")
    try:
        axes = ("data",) if shape is None else ("data", "space")
        mesh = pdist.global_stream_mesh(axes, local_devices=[device] * slots, shape=shape)
        held = local_rows(stream_square_sharding(mesh).local_blocks(n))
        with np.load(frames_path) as z:
            refs = np.stack([z[f"ref_{i}"] for i in held])
            steps = np.stack([z[f"step_{i}"] for i in held])
        local = pdist.distribute_local_streams(mesh, steps)
        check(local.streams == held and local.global_shape == (n,) + steps.shape[1:],
              f"rank {rank}: streams {local.streams} of {local.global_shape}, want {held}")
        ms = tms.MultiStreamPipeline(g, n, mesh=mesh)
        mine = ms.rows
        check(ms.frame_rows == held, f"rank {rank}: frame rows {ms.frame_rows}, want {held}")
        state = ms.capture_reference(ms.init_state(), refs)
        state, out = ms.step(state, local.frames)
        expected = np.load(expected_path)
        occ = tms.outputs_to_numpy(out).step.occupancy
        check(out.streams == mine, f"rank {rank}: outputs hold streams {out.streams}, want {mine}")
        check(np.array_equal(occ, expected["occ"][mine.start:mine.stop]),
              f"rank {rank}: occupancy of streams {mine.start}:{mine.stop} differs from the "
              "expected rows")
        checked = _check_expected(expected, 0, out, mine, rank)
        if masks is not None:
            # Wrong masks for the rows this process does not own: a split
            # row must run on its owner's.
            given = masks[held.start:held.stop].copy()
            foreign = [i - held.start for i in held if i not in mine]
            given[foreign] = ~given[foreign]
            state, out = ms.step(state, local.frames, s2c_masks=given)
            checked += _check_expected(expected, 1, out, mine, rank)
        total = pdist.fleet_sum(out.step.occupancy.to(torch.int32)).cpu().numpy()
        last = f"t{0 if masks is None else 1}_occupancy"  # the last tick's, where given
        want = expected[last] if last in expected.files else expected["occ"]
        check(np.array_equal(total, want.sum(axis=0)),
              f"rank {rank}: fleet sum of occupancy {total} != expected {want.sum(axis=0)}")
        print(f"FLEET-OK rank={rank} streams={mine.start}:{mine.stop} of {n} on "
              f"{len(ms.slots)} slots ({device}, {torch.distributed.get_backend()}, mesh "
              f"{mesh.shape}, frame rows {held.start}:{held.stop}); {checked} expected "
              f"arrays equal; fleet occupancy sum {int(total.sum())}", flush=True)
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
