"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is present.

    The port's entry points default to ``"cuda"``.  A run that asked for
    the card must never quietly fall back to the CPU, so this raises.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
