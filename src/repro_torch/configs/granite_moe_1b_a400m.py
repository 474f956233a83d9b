"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512 (per-expert) vocab=49155,
MoE 32 experts top-8 on every layer.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    ffn_type="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,
    moe=MoEConfig(
        n_experts=32,
        top_k=8,
        d_ff_expert=512,
        every_n_layers=1,
    ),
    param_dtype="bfloat16",
)
