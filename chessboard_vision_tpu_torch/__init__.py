"""chessboard_vision_tpu_torch: the PyTorch/CUDA port of chessboard_vision_tpu.

The JAX package beside it is the reference. This package imports torch and
numpy, never jax, cv2 or the JAX package: it keeps its own copies of the
host modules it needs (``geometry``, ``rules``, ``utils.config``,
``utils.logging``). Module names mirror the JAX package's so each
counterpart is easy to find. Entry points run on the card (``"cuda"``)
unless the caller asks for the CPU.

Main path: ``models.pipeline.VisionPipeline`` (frame -> 64 per-square
``StepOutputs``) driven by ``session.game_session.GameSession``
(occupancy -> committed move -> FEN). Its hand-written kernels
(``kernels/*.cu``): the Hough score matmul, and on the enhanced path
(``with_enhancer=True``) the bilateral filter and CLAHE's histogram and
LUT apply. Recorded footage: ``tools.process_video`` (``run`` on a file,
``run_capture`` on frames in memory). One-call API: ``api`` (its entry
points are also attributes of this package, imported on first use).
"""

_API = {
    "enhance_frame", "extract_grid", "detect_pieces", "detect_changes", "frame_to_fen",
    "frame_to_full_fen", "generate_fen", "occupancy_to_fen", "occupancy_to_colored_fen",
    "digitize_video",
}


def __getattr__(name):
    """Lazy top-level API (``import chessboard_vision_tpu_torch`` stays free
    of torch and the pipeline's imports): the BASELINE-named convenience
    entry points of ``api`` and the main classes."""
    if name in _API:
        from chessboard_vision_tpu_torch import api

        return getattr(api, name)
    if name == "VisionPipeline":
        from chessboard_vision_tpu_torch.models.pipeline import VisionPipeline

        return VisionPipeline
    if name == "GameSession":
        from chessboard_vision_tpu_torch.session.game_session import GameSession

        return GameSession
    if name == "BoardGeometry":
        from chessboard_vision_tpu_torch.geometry import BoardGeometry

        return BoardGeometry
    raise AttributeError(f"module 'chessboard_vision_tpu_torch' has no attribute {name!r}")
