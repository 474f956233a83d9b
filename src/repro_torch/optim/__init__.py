"""The optimizer: AdamW with its schedule, and int8 gradient compression."""

from repro_torch.optim import grad_compress
from repro_torch.optim.adamw import (
    AdamWConfig,
    apply_updates,
    cosine_schedule,
    global_norm,
    init_state,
)

__all__ = [
    "AdamWConfig",
    "apply_updates",
    "cosine_schedule",
    "global_norm",
    "init_state",
    "grad_compress",
]
