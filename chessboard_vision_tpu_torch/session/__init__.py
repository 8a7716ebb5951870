"""Host control plane of the port (counterparts of chessboard_vision_tpu.session)."""
