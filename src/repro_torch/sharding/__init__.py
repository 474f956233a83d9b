"""Sharding rules and the ambient mesh; counterpart of ``repro.sharding``."""

from repro_torch.sharding.rules import (
    MeshAxes,
    batch_specs,
    decode_state_specs,
    param_specs,
    placements,
)

__all__ = ["MeshAxes", "batch_specs", "decode_state_specs", "param_specs", "placements"]
