"""Stateful models of the port (counterparts of chessboard_vision_tpu.models).

Each model carries its temporal state as an explicit tree of tensors
threaded through its step functions."""

from chessboard_vision_tpu_torch.models.change_detector import ChangeDetectorModel
from chessboard_vision_tpu_torch.models.piece_detector import PieceDetectorModel, PieceState
from chessboard_vision_tpu_torch.models.pipeline import PipelineState, StepOutputs, VisionPipeline

__all__ = [
    "PieceDetectorModel",
    "PieceState",
    "ChangeDetectorModel",
    "VisionPipeline",
    "PipelineState",
    "StepOutputs",
]
