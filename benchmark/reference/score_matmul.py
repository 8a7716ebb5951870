"""The Hough score matmul in plain PyTorch: the reference's stand-in for the
port's hand-written kernel (B1), as the port's own plain version computes it
(chessboard_vision_tpu_torch/kernels/score_matmul.py at commit 9f9af32,
``score_matmul_reference``): f32 products of the bf16 operands, f32 sums."""

from __future__ import annotations

import torch


def score_matmul(basis: torch.Tensor, pf: torch.Tensor) -> torch.Tensor:
    """scores[m, n] = sum_k basis[m, k] * pf[n, k]: (M, K) x (N, K) -> (M, N) f32."""
    return basis.float() @ pf.float().T
