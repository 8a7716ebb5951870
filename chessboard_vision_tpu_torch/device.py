"""The device an entry point runs on: the card unless the caller asks for
the CPU, and never the CPU in silence when a card was asked for."""

from __future__ import annotations

import torch


def resolve_device(device="cuda", who: str = "the port") -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and no CUDA
    device is available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: device {str(device)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return device


def synchronize(device) -> None:
    """Wait for the work queued on ``device``'s current stream, the one a
    step's outputs come from; nothing on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
