"""gemma-7b [arXiv:2403.08295].

28L d_model=3072 16H (kv=16, i.e. MHA) d_ff=24576 GeGLU head_dim=256
vocab=256000 (tied embeddings) — the 256k vocab makes the unembed/loss the
memory hot spot (see logits-chunked loss in §Perf).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    ffn_type="geglu",
    rope_theta=10000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
)
