"""Stream meshes: the slots of the N-stream path, and which streams and
squares each slot holds.

Counterpart of chessboard_vision_tpu.parallel.mesh. The workload has two
parallel axes:
- "data": independent camera streams (no cross-stream communication;
  collectives only for fleet-level reductions, parallel/distributed.py);
- "space": the 64-square axis inside each stream (the per-square
  perception core runs on a block of squares).

A ``StreamMesh`` is an explicit grid of device slots with axis names, read
like ``jax.sharding.Mesh`` (``.devices``, ``.axis_names``,
``.shape["space"]``), and for each slot the rank of the process that owns
it. A slot list may name one device more than once: ``devices=["cpu"] * 8``
is the CPU tests' counterpart of the JAX package's 8 virtual CPU devices,
and ``devices=["cuda:0"] * 8`` runs an 8-slot mesh on one card, each slot
with launches of its own.

Torch has no global sharded array: ``stream_sharding`` and
``stream_square_sharding`` give the map from a global stream index (and a
square block) to its slot, and the placement helpers cut a tree of (N, ...)
leaves into one tree a slot, on the slot's device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from chessboard_vision_tpu_torch.device import resolve_device
from chessboard_vision_tpu_torch.utils.checkpoint import tree_leaves, tree_map

DATA, SPACE = "data", "space"


def process_rank() -> int:
    """This process's rank in the torch.distributed group, 0 without one."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def slot_device(device) -> torch.device:
    """A slot's device: ``device`` resolved (a card that is missing
    raises), "cuda" without an index taken as the current card."""
    device = resolve_device(device, "make_mesh")
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise ValueError(f"make_mesh: no card cuda:{index}; this process sees "
                             f"{torch.cuda.device_count()}")
        device = torch.device("cuda", index)
    return device


class StreamMesh:
    """Device slots in a grid with named axes ("data", then optionally
    "space"), and the process rank that owns each slot. ``process`` is this
    process's rank: only its slots run here."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str], shape: Sequence[int],
                 ranks: Optional[Sequence[int]] = None, process: int = 0):
        axis_names, shape = tuple(axis_names), tuple(int(s) for s in shape)
        if axis_names not in ((DATA,), (DATA, SPACE)):
            raise ValueError(f"mesh axes {axis_names}: use ('data',) or ('data', 'space')")
        if len(shape) != len(axis_names) or int(np.prod(shape)) != len(devices):
            raise ValueError(f"mesh shape {shape} does not hold {len(devices)} slots "
                             f"on axes {axis_names}")
        grid = np.empty(len(devices), dtype=object)
        grid[:] = [torch.device(d) for d in devices]
        self.devices = grid.reshape(shape)
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        ranks = [process] * len(devices) if ranks is None else list(ranks)
        self.ranks = np.asarray(ranks, dtype=np.int64).reshape(shape)
        self.process = int(process)

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_size(self, name: str) -> int:
        return self.shape.get(name, 1)

    def __repr__(self) -> str:
        return (f"StreamMesh({self.shape}, devices={[str(d) for d in self.devices.flat]}, "
                f"ranks={self.ranks.ravel().tolist()}, process={self.process})")


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Sequence[str] = (DATA,),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence] = None,
) -> StreamMesh:
    """A mesh over the first ``n_devices`` slots of this process.

    By default the slots are this process's CUDA cards, one each; without a
    card it raises (device.resolve_device), it never drops to the CPU.
    ``devices`` names the slots instead, repeats allowed. Default shape: a
    1-D "data" mesh; pass ``shape`` for two axes, e.g.
    ``make_mesh(8, ("data", "space"), (4, 2))``."""
    if devices is None:
        resolve_device("cuda", "make_mesh")
        pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        pool = [slot_device(d) for d in devices]
    n = len(pool) if n_devices is None else int(n_devices)
    if n > len(pool):
        raise ValueError(
            f"make_mesh: requested {n} slots but only {len(pool)} available "
            f"({[str(d) for d in pool]}). For a mesh of more slots than cards, name "
            f"them with devices=, a device more than once (e.g. devices=['cuda:0'] * {n} "
            "on one card, ['cpu'] * n on the CPU): the counterpart of the JAX "
            "package's --xla_force_host_platform_device_count"
        )
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    return StreamMesh(pool[:n], axes, shape, process=process_rank())


class SlotBlock(NamedTuple):
    """One slot's share of N streams: its place in the grid (data row,
    space column), its device and owner, its global stream rows and its
    block of the 64 squares."""

    position: tuple
    device: torch.device
    rank: int
    streams: range
    squares: range


class StreamSharding(NamedTuple):
    """The map from global stream index (and, with ``split_squares``, square
    block) to slot. Without ``split_squares`` every slot of a data row
    holds the row's streams whole, as ``P("data")`` replicates over space."""

    mesh: StreamMesh
    split_squares: bool

    def blocks(self, n_streams: int) -> List[SlotBlock]:
        """Every slot's block for ``n_streams`` global streams, in mesh
        order. Slot (d, k) holds streams [d*n/dp, (d+1)*n/dp) and, split,
        squares [k*64/sp, (k+1)*64/sp)."""
        dp, sp = self.mesh.axis_size(DATA), self.mesh.axis_size(SPACE)
        if n_streams % dp:
            raise ValueError(f"{n_streams} streams do not divide over the mesh's "
                             f"'data' axis of {dp} slots")
        if self.split_squares and 64 % sp:
            raise ValueError(f"64 squares do not divide over the mesh's 'space' axis of {sp}")
        per, m = n_streams // dp, (64 // sp if self.split_squares else 64)
        out = []
        for d in range(dp):
            for k in range(sp):
                q0 = k * m if self.split_squares else 0
                out.append(SlotBlock(
                    (d, k), self.mesh.devices.reshape(dp, sp)[d, k],
                    int(self.mesh.ranks.reshape(dp, sp)[d, k]),
                    range(d * per, (d + 1) * per), range(q0, q0 + m),
                ))
        return out

    def local_blocks(self, n_streams: int) -> List[SlotBlock]:
        """The blocks of this process's slots."""
        return [b for b in self.blocks(n_streams) if b.rank == self.mesh.process]


def stream_sharding(mesh: StreamMesh) -> StreamSharding:
    """Leading (stream) axis over "data"; every slot holds its row's
    streams whole."""
    return StreamSharding(mesh, False)


def stream_square_sharding(mesh: StreamMesh) -> StreamSharding:
    """Streams over "data" and the 64-square axis over "space"."""
    return StreamSharding(mesh, True)


def local_rows(blocks: List[SlotBlock]) -> range:
    """The global stream rows the given (local) blocks hold, which must be
    contiguous."""
    rows = sorted({s for b in blocks for s in b.streams})
    if not rows or rows != list(range(rows[0], rows[-1] + 1)):
        raise ValueError(f"this process's slots hold no contiguous stream rows: {rows}")
    return range(rows[0], rows[-1] + 1)


def _leaf_to(x, rows: range, squares: Optional[range], device: torch.device) -> torch.Tensor:
    """A leaf's block (rows, and squares where given) on ``device``; a host
    array's block is copied."""
    block = (slice(rows.start, rows.stop),)
    if squares is not None:
        block += (slice(squares.start, squares.stop),)
    if isinstance(x, torch.Tensor):
        return x[block].to(device).contiguous()
    return torch.as_tensor(np.array(np.asarray(x)[block]), device=device)


def _shard(tree, mesh: StreamMesh, split: bool) -> list:
    blocks = StreamSharding(mesh, split).local_blocks(np.shape(tree_leaves(tree)[0])[0])

    def place(b):
        def leaf(x):
            square_axis = split and len(np.shape(x)) >= 2 and np.shape(x)[1] == 64
            return _leaf_to(x, b.streams, b.squares if square_axis else None, b.device)

        return tree_map(leaf, tree)

    return [place(b) for b in blocks]


def shard_pytree_leading_axis(tree, mesh: StreamMesh) -> list:
    """A tree of (N, ...) leaves (arrays or tensors, the N global streams)
    -> one tree a local slot, in mesh order, each holding its row's streams
    on its device."""
    return _shard(tree, mesh, False)


def shard_pytree_stream_square(tree, mesh: StreamMesh) -> list:
    """2-D placement: the leading (stream) axis over "data" and, for leaves
    whose second axis is the 64-square axis, that axis over "space"; other
    leaves hold their row's streams whole. One tree a local slot, in mesh
    order."""
    return _shard(tree, mesh, True)
