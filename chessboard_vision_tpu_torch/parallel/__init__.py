"""N camera streams on one device: the stream-folded batched pipeline and
the N-game session on top of it (multi-GPU waits: ROADMAP A14)."""

from chessboard_vision_tpu_torch.parallel.multistream import MultiStreamPipeline
from chessboard_vision_tpu_torch.parallel.session import MultiStreamSession

__all__ = ["MultiStreamPipeline", "MultiStreamSession"]
