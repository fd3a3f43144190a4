"""The device an entry point builds on: the card unless the caller asks for another."""

from __future__ import annotations

import torch


def card_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raise RuntimeError for a CUDA device
    when there is no card, instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available: the port's builders run on the card by default; "
            "pass device='cpu' to build on the CPU"
        )
    return dev
