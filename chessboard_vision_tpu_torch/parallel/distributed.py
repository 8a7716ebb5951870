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

Backends: NCCL where the process's slots are CUDA cards of its own, Gloo
otherwise (the CPU, or several processes on one card: NCCL refuses two
ranks on one card). Gloo in the card's torch (2.11.0+cu128) takes a CUDA
tensor in ``all_reduce`` (it stages it through the host itself;
chip_smoke's fleet phase runs ``fleet_sum`` on the card's tensors over
Gloo), so ``fleet_sum`` hands either backend the tensor where it lies.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional, Sequence

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
    """Each process's (local_streams, ...) frames as its share of the fleet's
    (world * local_streams, ...) batch over the mesh's "data" axis. Raises
    where the mesh puts other streams on this process's slots."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    frames = np.asarray(local_frames)
    n = frames.shape[0] * world
    rows = local_rows(stream_sharding(mesh).local_blocks(n))
    want = range(mesh.process * frames.shape[0], (mesh.process + 1) * frames.shape[0])
    if rows != want:
        raise ValueError(f"the mesh gives process {mesh.process}'s slots streams "
                         f"{rows.start}:{rows.stop} of {n}; its {frames.shape[0]} frames are "
                         f"streams {want.start}:{want.stop}")
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
