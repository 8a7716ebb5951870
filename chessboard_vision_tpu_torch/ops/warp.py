"""Board-geometry constants on the device and masked per-square reductions.

Counterpart of chessboard_vision_tpu.ops.warp. Only the fields the
frame -> FEN slice reads are carried; the HWC gather warp
(``frame_to_board``) waits for a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from chessboard_vision_tpu_torch.geometry import BoardGeometry


class DeviceGeometry(NamedTuple):
    """BoardGeometry constants read by the change model."""

    sq_mask_flat: torch.Tensor  # (64, H*W) bool valid interior pixels
    sq_counts: torch.Tensor  # (64,) i32 true pixel counts per square

    @classmethod
    def from_host(cls, geom: BoardGeometry, device="cpu") -> "DeviceGeometry":
        s = geom.squares
        return cls(
            sq_mask_flat=torch.as_tensor(
                s.mask.reshape(s.mask.shape[0], -1), device=device
            ),
            sq_counts=torch.as_tensor(s.counts, device=device),
        )


def masked_mean(x: torch.Tensor, mask: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Mean over each square's valid region. x: (64, H, W) -> (64,) f32.

    The f32 sum is exact for u8 inputs (integers below 2^24), so the result
    does not depend on the summation order."""
    s = (x.float() * mask).sum(dim=(-2, -1))
    return s / counts.float()
