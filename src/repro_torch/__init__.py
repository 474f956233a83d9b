"""PyTorch/CUDA port of the MapReduce config->time modeling system.

Mirrors the layout of the JAX package ``repro`` (``mapreduce/``,
``kernels/``, ``core/``) so every module has one counterpart there, which
stays the reference it is held against.  This package imports ``torch``
and numpy only: never ``jax`` and never ``repro``.

Every entry point takes ``device=`` and defaults to ``"cuda"``; asking for
``"cuda"`` without a card raises instead of running on the CPU.  The
tests pass ``device="cpu"``.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
