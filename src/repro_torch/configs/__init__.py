"""Architecture registry: ``get_config(arch)`` and smoke variants.

Counterpart of ``repro.configs``; the dataclasses and the ten architecture
files are copies.  The reference's ``input_specs`` and ``concrete_batch``
(jax ``ShapeDtypeStruct``s and ``jax.random`` batches) have no counterpart.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    applicable_shapes,
)
from repro_torch.configs import (  # noqa: E402
    arctic_480b,
    gemma_7b,
    granite_moe_1b_a400m,
    hubert_xlarge,
    internvl2_26b,
    jamba_v0_1_52b,
    llama3_8b,
    qwen3_0_6b,
    qwen3_32b,
    rwkv6_3b,
)

_REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        granite_moe_1b_a400m,
        arctic_480b,
        internvl2_26b,
        gemma_7b,
        qwen3_0_6b,
        qwen3_32b,
        llama3_8b,
        rwkv6_3b,
        hubert_xlarge,
        jamba_v0_1_52b,
    )
}

ARCH_IDS = tuple(sorted(_REGISTRY))


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    return _REGISTRY[arch]


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (same as the
    reference's ``smoke_config``)."""
    cfg = get_config(arch)
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe,
            n_experts=4,
            top_k=min(moe.top_k, 2),
            d_ff_expert=64,
            d_ff_dense=64 if moe.dense_residual else 0,
            n_groups=1,
            capacity_factor=8.0,
        )
    return dataclasses.replace(
        cfg,
        n_layers=2 * cfg.pattern_period,
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=503 if cfg.family == "audio" else 512,
        moe=moe,
        embed_in_dim=24 if cfg.input_kind == "embeddings" or cfg.family == "vlm" else 0,
        n_patches=4 if cfg.family == "vlm" else 0,
        rwkv_head_size=16,
        mamba_d_state=4,
        mamba_d_conv=4,
        param_dtype="float32",
    )


__all__ = [
    "ModelConfig",
    "MoEConfig",
    "ShapeConfig",
    "SHAPES",
    "ARCH_IDS",
    "applicable_shapes",
    "get_config",
    "smoke_config",
]
