"""Device selection for the port's entry points: the card unless the caller
asks for the CPU, and never a silent fall back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)`` with a CUDA index filled in (``"cuda"`` ->
    ``cuda:<current>``); raises if it is a CUDA device and no GPU is
    available."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
