"""rwkv6-3b (Finch) [arXiv:2404.05892].

32L d_model=2560, attention-free (WKV6 time-mix with data-dependent decay +
channel-mix), d_ff=8960, vocab=65536, head_size=64 (40 heads).
Runs the long_500k cell: decode state is O(1) in context length.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    block_pattern=("rwkv",),
    rwkv_head_size=64,
    param_dtype="bfloat16",
)
