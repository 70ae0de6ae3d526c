"""Where the port runs: every entry point takes ``device="cuda"`` unless
the caller asks for the CPU, and refuses a card that is not there or
operands that lie elsewhere."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA request without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path")
    return dev


def check_on(tree, dev: torch.device, what: str) -> None:
    """Raise unless every tensor of ``tree`` lies on ``dev``'s device type."""
    for t in tree_leaves(tree):
        if t.device.type != dev.type:
            raise ValueError(f"{what} lies on {t.device}, not on {dev}")
