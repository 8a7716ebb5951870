"""chessboard_vision_tpu_torch: the PyTorch/CUDA port of chessboard_vision_tpu.

The JAX package beside it is the reference. This package imports torch and
numpy, never jax or cv2; from the JAX package it imports only the jax-free
host modules (``geometry``, ``rules``, ``utils.config``, ``utils.logging``).
Module names mirror the JAX package's so each counterpart is easy to find.

Main path: ``models.pipeline.VisionPipeline`` (frame -> 64 per-square
``StepOutputs``) driven by ``session.game_session.GameSession``
(occupancy -> committed move -> FEN). The one hand-written kernel on that
path is the Hough score matmul, ``kernels/score_matmul.cu``.
"""
