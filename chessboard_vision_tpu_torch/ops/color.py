"""BGR -> gray with OpenCV's u8 fixed-point arithmetic.

Y = (R*9798 + G*19235 + B*3735 + 2^14) >> 15, in int32: bit-exact against
cv2.COLOR_BGR2GRAY and against chessboard_vision_tpu.ops.color.
"""

from __future__ import annotations

import torch

_R2Y, _G2Y, _B2Y, _GRAY_SHIFT = 9798, 19235, 3735, 15


def _gray(b: torch.Tensor, g: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    b, g, r = (c.to(torch.int32) for c in (b, g, r))
    y = (r * _R2Y + g * _G2Y + b * _B2Y + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT
    return y.to(torch.uint8)


def bgr2gray(bgr: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) BGR u8 -> (..., H, W) gray u8."""
    return _gray(bgr[..., 0], bgr[..., 1], bgr[..., 2])


def planar_bgr2gray(planar: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) planar BGR u8 -> (..., H, W) gray u8."""
    return _gray(planar[..., 0, :, :], planar[..., 1, :, :], planar[..., 2, :, :])
