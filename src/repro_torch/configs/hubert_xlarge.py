"""hubert-xlarge [arXiv:2106.07447] — encoder-only audio transformer.

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (cluster targets).
The CNN waveform frontend is a STUB per the brief: ``input_specs()``
supplies precomputed frame embeddings (width 512).  Encoder-only: no
decode shapes (see DESIGN.md skips).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    ffn_type="gelu",
    causal=False,
    input_kind="embeddings",
    embed_in_dim=512,
    param_dtype="bfloat16",
)
