"""arctic-480b [hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 PLUS a parallel dense-residual FFN per layer
(Arctic's dense-MoE hybrid design).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    ffn_type="swiglu",
    rope_theta=10000.0,
    moe=MoEConfig(
        n_experts=128,
        top_k=2,
        d_ff_expert=4864,
        every_n_layers=1,
        dense_residual=True,
        d_ff_dense=4864,
        n_groups=16,
    ),
    param_dtype="bfloat16",
)
