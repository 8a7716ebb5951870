"""Stateful models of the port (counterparts of chessboard_vision_tpu.models)."""
