"""Multi-process stream meshes over torch.distributed.

Counterpart of chessboard_vision_tpu.parallel.distributed. The
single-process mesh (parallel/mesh.py) covers one process's slots; this
module spans the same mesh over several processes: a fleet of camera rigs
whose streams are sharded over the global "data" axis, each process's
streams on its own slots. Stream frames never leave their process; only
fleet-level reductions (``fleet_sum``) cross between processes.

- ``init_distributed`` wires the processes with
  ``torch.distributed.init_process_group`` over TCP, from explicit
  arguments, the ``CBV_COORDINATOR``/``CBV_NUM_PROCESSES``/``CBV_PROCESS_ID``
  variables or torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
  ``WORLD_SIZE`` (the torch counterpart of a TPU pod's auto-detection).
- ``global_stream_mesh`` orders every process's slots process-major, so a
  1-D "data" mesh gives each process a contiguous block of streams.
- ``distribute_local_streams`` is the counterpart of
  ``jax.make_array_from_process_local_data``: torch has no global array, so
  it returns the process's frames with their global stream rows, checked
  against the mesh; ``MultiStreamPipeline.step`` on such a mesh takes
  those frames.
- ``row_groups``, ``row_gather`` and ``row_broadcast`` carry a data row
  whose space slots belong to more than one process (where the space axis
  does not divide a process's slots): one process group a such row, made
  at the pipeline's construction in the same order on every process, and
  per tick a broadcast of the row's flags from the process that owns the
  row (the one holding its first slot) and a gather of the other
  processes' square blocks onto it. A process that holds no slot of a row
  joins none of that row's calls.

Backends: NCCL where the process's slots are CUDA cards of its own, Gloo
otherwise (the CPU, or several processes on one card: NCCL refuses two
ranks on one card). Gloo in the card's torch (2.11.0+cu128) takes a CUDA
tensor in ``all_reduce`` (it stages it through the host itself;
chip_smoke's fleet phase runs ``fleet_sum`` on the card's tensors over
Gloo), so ``fleet_sum`` hands either backend the tensor where it lies.
So does the row exchange: Gloo there takes CUDA tensors in ``gather`` and
``broadcast`` too (checked on the card: both, and ``all_gather``, gave the
right values between two processes on cuda:0). Only the row's flags,
which start on the host, are moved onto the card for NCCL.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from chessboard_vision_tpu_torch.parallel.mesh import (
    DATA,
    StreamMesh,
    local_rows,
    make_mesh,
    stream_sharding,
)
from chessboard_vision_tpu_torch.utils.logging import get_logger

log = get_logger("distributed")

# The process group's timeout: its TCP rendezvous and every collective give
# up after it, so a lost peer fails a run instead of hanging it.
TIMEOUT = datetime.timedelta(seconds=120)


def _env_int(name: str) -> Optional[int]:
    return int(os.environ[name]) if name in os.environ else None


def _auto_backend(num_processes: int) -> str:
    """NCCL when this host's processes each have a card of their own, else
    Gloo. Processes on this host: torchrun's LOCAL_WORLD_SIZE, else all of
    them (a launch without torchrun is taken as one host's)."""
    local = _env_int("LOCAL_WORLD_SIZE") or num_processes
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return "nccl" if dist.is_nccl_available() and 0 < local <= cards else "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "auto",
) -> bool:
    """Initialize the process group (idempotent). ``coordinator_address``
    is "host:port" of rank 0's rendezvous. Returns True when the group is
    up (or already was); False, logging why, when it is not configured or
    cannot start, and callers then run single-process."""
    if not dist.is_available():
        log.warning("distributed init unavailable: torch.distributed is not built in")
        return False
    if dist.is_initialized():
        return True
    address = coordinator_address or os.environ.get("CBV_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("CBV_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("CBV_PROCESS_ID")
    if address is None and num_processes is None and process_id is None \
            and "MASTER_ADDR" in os.environ:  # torchrun
        address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        num_processes, process_id = _env_int("WORLD_SIZE"), _env_int("RANK")
    missing = [name for name, v in (("coordinator address", address),
                                    ("number of processes", num_processes),
                                    ("process id", process_id)) if v is None]
    if missing:
        log.warning("distributed init unavailable (no %s: pass it, set CBV_COORDINATOR/"
                    "CBV_NUM_PROCESSES/CBV_PROCESS_ID, or launch with torchrun); running "
                    "single-process", ", ".join(missing))
        return False
    if backend == "auto":
        backend = _auto_backend(num_processes)
        log.info("distributed backend: %s (auto)", backend)
    if backend == "nccl":
        local_rank = _env_int("LOCAL_RANK")
        torch.cuda.set_device((process_id if local_rank is None else local_rank)
                              % torch.cuda.device_count())
    try:
        dist.init_process_group(backend=backend, init_method=f"tcp://{address}",
                                world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    except (RuntimeError, ValueError) as e:
        log.warning("distributed init failed (%s); running single-process", e)
        return False
    log.info("distributed group up: process %d/%d, backend %s", dist.get_rank(),
             dist.get_world_size(), backend)
    return True


def global_stream_mesh(axes: Sequence[str] = (DATA,), local_devices: Optional[Sequence] = None,
                       shape: Optional[Sequence[int]] = None) -> StreamMesh:
    """A mesh over every process's slots, process-major, so each process's
    streams sit on its own slots. ``local_devices``: this process's slots
    (repeats allowed; default its CUDA cards). The slot lists are
    exchanged with one ``all_gather_object``; without a process group this
    is the local mesh."""
    local = make_mesh(axes=(DATA,), devices=local_devices)
    own = [str(d) for d in local.devices.flat]
    if not dist.is_initialized():
        return make_mesh(len(own), axes, shape, devices=own)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, own)
    devices = [d for slots in everyone for d in slots]
    ranks = [r for r, slots in enumerate(everyone) for _ in slots]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axes) - 1)
    return StreamMesh(devices, axes, shape, ranks=ranks, process=dist.get_rank())


class LocalStreams(NamedTuple):
    """This process's frames on a mesh across processes, with their global
    stream rows and the fleet batch's global shape."""

    frames: np.ndarray
    streams: range
    global_shape: tuple


def distribute_local_streams(mesh: StreamMesh, local_frames) -> LocalStreams:
    """Each process's frames as its share of the fleet's batch over the
    mesh's "data" axis: the frames of every data row in which it holds a
    slot, in row order (a row split over processes is given to each of
    them). The fleet's stream count follows from the mesh: the rows this
    process holds take ``len(local_frames)`` streams. Raises where that
    does not divide over the rows, or where the mesh gives this process
    rows that are not contiguous."""
    frames = np.asarray(local_frames)
    dp = mesh.axis_size(DATA)
    ranks = mesh.ranks.reshape(dp, -1)
    held = int(sum((row == mesh.process).any() for row in ranks))
    if held == 0:
        raise ValueError(f"process {mesh.process} holds no slot of {mesh}")
    if (frames.shape[0] * dp) % held:
        raise ValueError(f"{frames.shape[0]} streams do not divide over this process's "
                         f"{held} data rows")
    n = frames.shape[0] * dp // held
    rows = local_rows(stream_sharding(mesh).local_blocks(n))
    return LocalStreams(frames, rows, (n,) + frames.shape[1:])


def fleet_sum(per_stream: torch.Tensor) -> torch.Tensor:
    """The fleet's total of a per-stream output: this process's (n_local,
    ...) rows summed, then summed over the group with one ``all_reduce``,
    the same (...) tensor on every process (the JAX fleet's reduction with
    replicated output)."""
    total = per_stream.sum(dim=0)
    if dist.is_initialized():
        dist.all_reduce(total)
    return total


def row_groups(mesh: StreamMesh) -> Dict[int, object]:
    """One process group a data row whose slots belong to more than one
    process, keyed by the row, made in row order. Every process must call
    this at the same point, as ``new_group`` requires; a process that
    holds no slot of a row gets a group it never uses. Each group's calls
    give up after TIMEOUT."""
    rows = {d: sorted({int(r) for r in ranks})
            for d, ranks in enumerate(mesh.ranks.reshape(mesh.axis_size(DATA), -1))
            if len(set(ranks.tolist())) > 1}
    if rows and not dist.is_initialized():
        raise ValueError(f"{mesh} splits data rows {sorted(rows)} over processes: that needs "
                         "a torch.distributed group (init_distributed) on every process")
    return {d: dist.new_group(ranks, timeout=TIMEOUT) for d, ranks in rows.items()}


def row_gather(t: torch.Tensor, owner: int, ranks: Sequence[int], group) -> Optional[dict]:
    """Every member's ``t`` (one shape on all of them) on ``owner``: a dict
    from member rank to its tensor, on ``t``'s device; None on the other
    members, which send theirs."""
    if dist.get_rank() != owner:
        dist.gather(t, None, dst=owner, group=group)
        return None
    bufs = [torch.empty_like(t) for _ in ranks]
    dist.gather(t, bufs, dst=owner, group=group)
    return dict(zip(sorted(ranks), bufs))


def row_broadcast(t: torch.Tensor, owner: int, group, device: torch.device) -> torch.Tensor:
    """The owner's host tensor ``t`` on every member of the row's group, on
    the host (moved onto ``device`` for the call under NCCL, which takes
    card tensors only)."""
    staged = t.to(device) if dist.get_backend(group) == "nccl" else t
    dist.broadcast(staged, src=owner, group=group)
    return staged.cpu()
