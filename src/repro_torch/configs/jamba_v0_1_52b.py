"""jamba-v0.1-52b [arXiv:2403.19887] — Mamba+attention 1:7 hybrid with MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16 experts
top-2 on every other layer.  Period-8 block pattern with one attention
layer per period (position 4, per the paper's l=8, a=1 layout).
Runs the long_500k cell (only 4 of 32 layers carry a KV cache).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    ffn_type="swiglu",
    block_pattern=(
        "mamba", "mamba", "mamba", "mamba",
        "attn", "mamba", "mamba", "mamba",
    ),
    moe=MoEConfig(
        n_experts=16,
        top_k=2,
        d_ff_expert=14336,
        every_n_layers=2,
        offset=1,
        n_groups=16,
    ),
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    param_dtype="bfloat16",
)
