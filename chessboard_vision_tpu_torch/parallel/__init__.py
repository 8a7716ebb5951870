"""Parallel layer: the stream-folded N-stream pipeline and the N-game
session on top of it, stream meshes (streams over a "data" axis of slots,
squares over an optional "space" axis) and the multi-process fleet on
torch.distributed."""

from chessboard_vision_tpu_torch.parallel.distributed import (
    distribute_local_streams,
    global_stream_mesh,
    init_distributed,
)
from chessboard_vision_tpu_torch.parallel.mesh import make_mesh, stream_sharding
from chessboard_vision_tpu_torch.parallel.multistream import MultiStreamPipeline
from chessboard_vision_tpu_torch.parallel.session import MultiStreamSession

__all__ = [
    "make_mesh",
    "stream_sharding",
    "MultiStreamPipeline",
    "init_distributed",
    "global_stream_mesh",
    "distribute_local_streams",
    "MultiStreamSession",
]
