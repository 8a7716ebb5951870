"""Network layer: the Lichess Board API client."""

from chessboard_vision_tpu_torch.net.lichess_client import LichessClient

__all__ = ["LichessClient"]
