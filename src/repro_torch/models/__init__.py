"""The LM stack's models: layers, attention, RWKV, and the decoder transformer."""

from repro_torch.models import attention, layers, ssm, transformer

__all__ = ["attention", "layers", "ssm", "transformer"]
