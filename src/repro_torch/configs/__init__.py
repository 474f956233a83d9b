"""Architecture registry: ``get_config(arch)``, smoke variants, input specs.

Counterpart of ``repro.configs``; the dataclasses and the ten architecture
files are copies.  ``input_specs`` gives each input's (shape, dtype) where
the reference gives ``jax.ShapeDtypeStruct``s, and ``concrete_batch``
draws a batch of those shapes from a numpy seed onto a device (the same
distributions as the reference's ``jax.random`` batch, not the same
numbers).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """{name: (shape, dtype)} for every model input of one shape cell.

    train / prefill: the whole (B, S) batch; a VLM's text is S - n_patches
    tokens after n_patches patch embeddings.  decode: (B, 1) new tokens,
    and for a VLM an empty (B, 0, embed_in_dim) patch prefix (the cache or
    state is built separately).  An encoder takes frame embeddings, plus
    per-frame ``labels`` to train.
    """
    B = shape.global_batch
    decode = shape.kind == "decode"
    S = 1 if decode else shape.seq_len
    f32, i32 = torch.float32, torch.int32
    if cfg.family == "vlm":
        n_txt = 1 if decode else max(S - cfg.n_patches, 1)
        n_pat = 0 if decode else cfg.n_patches
        return {"tokens": ((B, n_txt), i32),
                "patches": ((B, n_pat, cfg.embed_in_dim), f32)}
    if cfg.input_kind == "embeddings":
        spec = {"embeds": ((B, S, cfg.embed_in_dim), f32)}
        if shape.kind == "train":
            spec["labels"] = ((B, S), i32)
        return spec
    return {"tokens": ((B, S), i32)}


def concrete_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                   device="cpu") -> dict:
    """A batch matching :func:`input_specs`, drawn from
    ``numpy.random.default_rng(seed)`` onto ``device``: integers uniform
    in [0, vocab_size), floats standard normal."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shp, dtype) in input_specs(cfg, shape).items():
        if dtype == torch.int32:
            a = rng.integers(0, cfg.vocab_size, size=shp, dtype=np.int32)
        else:
            a = rng.standard_normal(shp, dtype=np.float32)
        out[name] = torch.from_numpy(a).to(device)
    return out


__all__ = [
    "ModelConfig",
    "MoEConfig",
    "ShapeConfig",
    "SHAPES",
    "ARCH_IDS",
    "applicable_shapes",
    "get_config",
    "smoke_config",
    "input_specs",
    "concrete_batch",
]
