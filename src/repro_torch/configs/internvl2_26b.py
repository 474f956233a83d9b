"""internvl2-26b [arXiv:2404.16821] — InternViT (stub) + InternLM2-20B.

Backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
The vision frontend is a STUB per the brief: ``input_specs()`` supplies
precomputed patch embeddings (width 3200, InternViT-6B hidden size) which
the model projects into the LM and prepends to the text sequence.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    ffn_type="swiglu",
    rope_theta=1_000_000.0,
    embed_in_dim=3200,
    n_patches=256,
    param_dtype="bfloat16",
)
