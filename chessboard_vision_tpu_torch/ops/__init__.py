"""Per-stage tensor ops of the port (counterparts of chessboard_vision_tpu.ops)."""
