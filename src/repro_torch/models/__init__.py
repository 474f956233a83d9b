"""The LM stack's models: layers, attention, and the decoder transformer."""

from repro_torch.models import attention, layers, transformer

__all__ = ["attention", "layers", "transformer"]
