# Frozen copy of chessboard_vision_tpu_torch/ops/xla_rounding.py at commit 9f9af32, for the
# benchmark's plain reference: imports rewritten to this folder, nothing else
# changed unless a "reference:" comment says so.
"""The f32 rounding of XLA:CPU's contracted multiply-adds, reproduced.

Inside a jitted (fused) program XLA:CPU contracts ``a*b + c*d`` into
``fma(a, b, c*d)``: the first product is fused, the second one rounded.
Where a u8 rounding or a carried f32 state depends on those last bits
(the resample lerp, the EMA change model, the Hough planes), the port
rounds the same way so its outputs stay bit-equal to the JAX package's
on the CPU. The fused multiply-add runs in float64, which holds the
product of two f32 values exactly, then rounds once to f32.
"""

from __future__ import annotations

import torch


def fma(x: torch.Tensor, y, c: torch.Tensor) -> torch.Tensor:
    """x*y + c with one f32 rounding. y is a tensor or an f32-exact float."""
    return (x.double() * y + c.double()).float()
