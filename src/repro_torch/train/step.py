"""Serve-side step factories; counterpart of the serving half of ``repro.train.step``.

Each ``build_*`` function returns a plain function over the model and a batch.  There is
no jit: PyTorch runs the steps eagerly.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf


@dataclasses.dataclass(frozen=True)
class StepConfig:
    logits_chunk: int = 0          # 0 = full logits
    use_flash: bool = False        # attention through the hand-written kernels
    cache_dtype: str = "bfloat16"  # KV cache dtype


def build_eval_step(cfg: ModelConfig, step_cfg: StepConfig = StepConfig()):
    """(model, batch) -> forward-only LM loss (scoring)."""

    def eval_step(model, batch):
        return tf.loss_fn(model, cfg, batch, use_flash=step_cfg.use_flash,
                          logits_chunk=step_cfg.logits_chunk)

    return eval_step


def build_prefill_step(cfg: ModelConfig, max_len: int,
                       step_cfg: StepConfig = StepConfig()):
    """(model, batch) -> (last-token logits, decode state)."""
    if not cfg.causal:
        raise NotImplementedError(
            f"{cfg.name}: encoder prefill is not ported yet (ROADMAP.md queue 1, "
            "item 10: VLM and audio inputs)")
    cache_dtype = getattr(torch, step_cfg.cache_dtype)

    def prefill_step(model, batch):
        return tf.prefill(model, cfg, batch, max_len, use_flash=step_cfg.use_flash,
                          cache_dtype=cache_dtype)

    return prefill_step


def build_decode_step(cfg: ModelConfig, step_cfg: StepConfig = StepConfig()):
    """(model, state, batch (B, S)) -> (logits, state); the state is updated in place."""

    def decode(model, state, batch):
        return tf.decode_step(model, cfg, state, batch, use_flash=step_cfg.use_flash)

    return decode
