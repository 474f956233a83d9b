"""Model / run configuration dataclasses shared across the framework."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    every_n_layers: int = 1        # MoE on layers where (idx % every_n) == offset
    offset: int = 0
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    d_ff_dense: int = 0            # width of the parallel dense FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    n_groups: int = 1              # dispatch groups (== expected data shards)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | ssm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    ffn_type: str = "swiglu"       # swiglu | geglu | relu
    qk_norm: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    # Layer pattern: period-P list of block kinds ("attn" | "mamba" | "rwkv"),
    # tiled to n_layers.  Homogeneous archs use ("attn",) etc.
    block_pattern: tuple[str, ...] = ("attn",)
    # Input modality: "tokens" (int ids) or "embeddings" (stub frontend
    # supplies pre-computed frame/patch embeddings of width embed_in_dim).
    input_kind: str = "tokens"
    embed_in_dim: int = 0
    # VLM: number of image patch embeddings prepended to the text sequence.
    n_patches: int = 0
    # SSM geometry.
    rwkv_head_size: int = 64
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    norm_eps: float = 1e-6
    # Numerics.
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Megatron-style vocab padding to a multiple of 256 so the vocab
        dimension shards evenly on any mesh axis up to 256.  Pad logits are
        masked to -inf in ``unembed``; pad embedding rows are never
        gathered (token ids < vocab_size)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_groups_of_layers(self) -> int:
        if self.n_layers % self.pattern_period:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern period {self.pattern_period}"
            )
        return self.n_layers // self.pattern_period

    def layer_kinds(self) -> list[str]:
        return [
            self.block_pattern[i % self.pattern_period]
            for i in range(self.n_layers)
        ]

    def is_moe_layer(self, idx: int) -> bool:
        if self.moe is None:
            return False
        return idx % self.moe.every_n_layers == self.moe.offset

    def active_params(self) -> float:
        """Parameters touched per token (MoE counts top_k experts only)."""
        return self._param_count(active_only=True)

    def total_params(self) -> float:
        return self._param_count(active_only=False)

    def _param_count(self, active_only: bool) -> float:
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        total = float(self.vocab_size * d)  # embed
        if not self.tie_embeddings and self.input_kind == "tokens":
            total += self.vocab_size * d   # lm_head
        if self.input_kind == "embeddings":
            total += self.embed_in_dim * d
        per_ffn = (
            3 * d * self.d_ff
            if self.ffn_type in ("swiglu", "geglu")
            else 2 * d * self.d_ff
        )
        for i, kind in enumerate(self.layer_kinds()):
            if kind == "attn":
                total += d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
            elif kind == "mamba":
                d_in = self.mamba_expand * d
                total += (
                    d * 2 * d_in                    # in_proj
                    + d_in * self.mamba_d_conv      # conv
                    + d_in * (2 * self.mamba_d_state + 1)  # B,C,dt proj (approx)
                    + d_in                          # A diag (per-channel) + D
                    + d_in * d                      # out_proj
                )
            elif kind == "rwkv":
                total += 4 * d * d + d * d  # r,k,v,g,o projections (+ small mixes)
            if self.is_moe_layer(i):
                m = self.moe
                e = m.top_k if active_only else m.n_experts
                per_expert = (
                    3 * d * m.d_ff_expert
                    if self.ffn_type in ("swiglu", "geglu")
                    else 2 * d * m.d_ff_expert
                )
                total += e * per_expert + d * m.n_experts  # + router
                if m.dense_residual and m.d_ff_dense:
                    total += 3 * d * m.d_ff_dense
            elif kind == "rwkv":
                # channel-mix: W_k (d x d_ff), W_v (d_ff x d), W_r (d x d)
                total += 2 * d * self.d_ff + d * d
            else:
                total += per_ffn
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str           # train_4k | prefill_32k | decode_32k | long_500k
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Shape cells that apply to an arch (skips per brief, see DESIGN.md)."""
    shapes = ["train_4k", "prefill_32k"]
    encoder_only = not cfg.causal
    if not encoder_only:
        shapes.append("decode_32k")
        subquadratic = any(k in ("mamba", "rwkv") for k in cfg.block_pattern)
        if subquadratic:
            shapes.append("long_500k")
    return shapes
