"""The port's one device guard: entry points that build device state take
``device="cuda"`` by default and raise where there is no card, with no
fallback to the CPU."""

from __future__ import annotations

import torch


def device_for(device, who: str, hint: str = "") -> torch.device:
    """``device`` as a torch device; "cuda" raises where there is no card
    (``who`` names the entry point, ``hint`` ends the message)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device cuda requested and CUDA is not available{hint}")
    return device
