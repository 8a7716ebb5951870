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
LUT apply.
"""
