"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card.  A CUDA device without a card raises: the
    port never carries on quietly on the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this entry point runs on the card by "
            "default; pass device='cpu' to run its plain PyTorch path"
        )
    return dev


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A seeded generator on the device of the computation."""
    return torch.Generator(device=device).manual_seed(int(seed))
