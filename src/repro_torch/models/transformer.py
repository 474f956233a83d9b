"""The LM: attention, Mamba and RWKV blocks over token, VLM or audio input.

Counterpart of ``repro.models.transformer``:

* ``"attn"``: norm -> GQA attention -> residual, then the FFN sub-block;
* ``"mamba"``: norm -> selective SSM -> residual, then the FFN sub-block;
* ``"rwkv"``: norm -> time-mix -> residual, norm -> channel-mix -> residual.

The FFN sub-block is a dense FFN, or on the layers ``cfg.is_moe_layer``
names an MoE FFN (``models.moe.moe_ffn_grouped``), with arctic's dense FFN
of width ``d_ff_dense`` in parallel when ``dense_residual`` is set; the MoE
layers' Switch aux losses are summed over the layers.  The reference
stacks each in-period position's parameters over repeats and scans them;
here the blocks are an ``nn.ModuleList`` in layer order (layer
``i = rep * P + p``) and a Python loop runs them.

Input comes in three kinds, as in the reference: token ids (``tokens``);
a VLM's patch embeddings (``patches``, width ``embed_in_dim``) projected
by ``in_proj`` and put in front of its text ``tokens``, its loss on text
positions only; an audio encoder's frame embeddings (``embeds``)
projected by ``in_proj``, with a per-frame loss against ``labels``
(-100 masked) and no token embedding.

The config passed to ``forward``, ``loss_fn`` and ``decode_step`` sets the
computation (the compute dtype, the MoE capacity factor); the one a
model was built with sets its shapes.  The weights are trainable
parameters: ``forward`` and ``loss_fn`` run
under autograd when the caller has it on (the train step), with ``remat``
as the reference's; ``decode_step`` and ``prefill`` never record a graph.
The decode state keeps its write position as a host int, so a step never
reads the device; attention caches are updated in place, RWKV and Mamba
states replaced by each call's new state.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention, init_cache
from repro_torch.models.layers import (
    cross_entropy_loss,
    dense_weight,
    ffn_apply,
    ffn_shapes,
    rmsnorm,
)
from repro_torch.models.moe import MoE, moe_ffn_grouped
from repro_torch.models.ssm import (
    RWKV,
    Mamba,
    mamba_block,
    mamba_state_init,
    rwkv_channel_mix,
    rwkv_state_init,
    rwkv_time_mix,
)
from repro_torch.sharding.context import (
    constraint,
    current_mesh,
    is_dtensor,
    local_placements,
    local_region,
    shard_start,
)
from repro_torch.sharding.rules import mesh_shape_of


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a block kind or an input kind the model does not know."""
    unknown = set(cfg.block_pattern) - {"attn", "mamba", "rwkv"}
    if unknown:
        raise ValueError(f"{cfg.name}: unknown block kinds {sorted(unknown)}")
    if cfg.input_kind not in ("tokens", "embeddings"):
        raise ValueError(f"{cfg.name}: unknown input kind {cfg.input_kind!r}")


def _moe_positions_valid(cfg: ModelConfig) -> None:
    """MoE placement must repeat with the block pattern (the reference's
    scan requirement, kept so that both packages accept the same configs)."""
    if cfg.moe is None:
        return
    if cfg.moe.every_n_layers > 1 and cfg.pattern_period % cfg.moe.every_n_layers:
        raise ValueError(
            f"{cfg.name}: pattern period {cfg.pattern_period} must be a multiple of "
            f"moe.every_n_layers={cfg.moe.every_n_layers} so MoE placement is "
            f"repeat-invariant (scan requirement)")


#: hidden states on a mesh: batch on dp, the rest replicated
DP_HIDDEN = (("pod", "data"), None, None)


def _residual(x, y):
    """x + y in x's dtype.  On a mesh the sub-block's output (a partial sum
    over ``model`` after a row-parallel product) is reduced to the hidden
    layout first, so that the residual stream stays batch-sharded on dp
    (DTensor would otherwise scatter it along the sequence)."""
    return x + constraint(y.to(x.dtype), *DP_HIDDEN)


class FFN(nn.Module):
    """Dense FFN of ``cfg.ffn_type`` and width ``d_ff`` (``cfg.d_ff`` by
    default); weights (d_in, d_out)."""

    def __init__(self, cfg, dtype, device, generator=None, d_ff: int | None = None):
        super().__init__()
        self.ffn_type = cfg.ffn_type
        shapes = ffn_shapes(cfg.d_model, d_ff or cfg.d_ff, cfg.ffn_type)
        for name, (d_in, d_out) in shapes.items():
            w = dense_weight(generator, d_in, d_out, dtype, device)
            self.register_parameter(name, nn.Parameter(w))

    def forward(self, x, compute_dtype):
        return ffn_apply(x, dict(self.named_parameters()), self.ffn_type, compute_dtype)


class _FFNBlock(nn.Module):
    """A block whose second half is norm -> FFN sub-block -> residual: a
    dense FFN, or on an MoE layer the MoE FFN (and arctic's parallel dense
    FFN of width ``d_ff_dense``)."""

    def _init_ffn(self, cfg, layer: int, dtype, device, generator):
        self.norm2 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype, device=device))
        self.moe = None
        if cfg.is_moe_layer(layer % cfg.pattern_period):
            self.moe = MoE(cfg, dtype, device, generator)
            if cfg.moe.dense_residual and cfg.moe.d_ff_dense:
                self.ffn = FFN(cfg, dtype, device, generator, d_ff=cfg.moe.d_ff_dense)
        else:
            self.ffn = FFN(cfg, dtype, device, generator)

    def _ffn(self, x, cfg):
        """x -> (x + the sub-block's output, aux: the MoE's or None)."""
        cdt = getattr(torch, cfg.compute_dtype)
        h = rmsnorm(x, self.norm2, cfg.norm_eps)
        if self.moe is None:
            return _residual(x, self.ffn(h, cdt)), None
        y, aux = moe_ffn_grouped(h, dict(self.moe.named_parameters()), cfg, cdt)
        if hasattr(self, "ffn"):
            # The reference's compiled block adds the two branches unrounded.
            y = y.float() + self.ffn(h, cdt).float()
        return _residual(x, y), aux


class Block(_FFNBlock):
    """norm -> attention -> residual, then the FFN sub-block."""

    def __init__(self, cfg, dtype, device, generator=None, layer: int = 0):
        super().__init__()
        self.norm1 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype, device=device))
        self.attn = Attention(cfg, dtype, device, generator)
        self._init_ffn(cfg, layer, dtype, device, generator)

    def forward(self, x, cache=None, *, cfg, pos=0, use_flash=False, wkv_kernel=True):
        """Returns (x, cache, aux); ``cache`` (k, v) is written in place at
        ``pos``.  ``wkv_kernel`` is the RWKV block's, unused here."""
        h = rmsnorm(x, self.norm1, cfg.norm_eps)
        y, cache = self.attn(h, cache=cache, cache_index=None if cache is None else pos,
                             use_flash=use_flash, cfg=cfg)
        x, aux = self._ffn(_residual(x, y), cfg)
        return x, cache, aux


class MambaBlock(_FFNBlock):
    """norm -> Mamba -> residual, then the FFN sub-block."""

    def __init__(self, cfg, dtype, device, generator=None, layer: int = 0):
        super().__init__()
        self.norm1 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype, device=device))
        self.mamba = Mamba(cfg, dtype, device, generator)
        self._init_ffn(cfg, layer, dtype, device, generator)

    def forward(self, x, state: dict | None = None, *, cfg, pos=0, use_flash=False,
                wkv_kernel=True):
        """Returns (x, new state, aux); without a state, from a zero float32
        one.  ``pos``, ``use_flash`` and ``wkv_kernel`` are the other
        blocks'."""
        if state is None:
            state = mamba_state_init(cfg, x.shape[0], device=x.device)
        y, state = mamba_block(rmsnorm(x, self.norm1, cfg.norm_eps), self.mamba, cfg, state)
        x, aux = self._ffn(_residual(x, y), cfg)
        return x, state, aux


class RWKVBlock(nn.Module):
    """norm -> time-mix -> residual, norm -> channel-mix -> residual; the
    channel-mix weights live in the ``rwkv`` parameters, as in the reference."""

    def __init__(self, cfg, dtype, device, generator=None, layer: int = 0):
        super().__init__()
        ones = lambda: nn.Parameter(torch.ones(cfg.d_model, dtype=dtype, device=device))
        self.norm1 = ones()
        self.rwkv = RWKV(cfg, dtype, device, generator)
        self.norm2 = ones()

    def forward(self, x, state: dict | None = None, *, cfg, pos=0, use_flash=False,
                wkv_kernel=True):
        """Returns (x, new state, None: no aux); without a state, from a zero
        float32 one.  ``wkv_kernel=False`` runs the recurrence's plain
        chunked form (the training route); ``pos`` and ``use_flash`` are the
        attention block's, unused here."""
        if state is None:
            state = rwkv_state_init(cfg, x.shape[0], device=x.device)
        y, state = rwkv_time_mix(rmsnorm(x, self.norm1, cfg.norm_eps), self.rwkv, cfg, state,
                                 wkv_kernel=wkv_kernel)
        x = _residual(x, y)
        y, state = rwkv_channel_mix(rmsnorm(x, self.norm2, cfg.norm_eps), self.rwkv, cfg, state)
        return _residual(x, y), state, None


class Transformer(nn.Module):
    """Input embedding, ``n_layers`` blocks, final norm, (tied) unembedding.

    The parameters are the reference's ``init_params``: ``embed`` for token
    input or a VLM, ``lm_head`` unless the embedding is tied, and
    ``in_proj`` (embed_in_dim, d_model) for embedding input or a VLM; an
    audio encoder has ``in_proj`` and ``lm_head`` and no ``embed``.
    ``generator`` draws the weights as the reference does (same
    distributions, not the same numbers); without one the weights are left
    uninitialised for ``load_state_dict``.
    """

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None = None,
                 device="cuda"):
        super().__init__()
        check_supported(cfg)
        _moe_positions_valid(cfg)
        dev = resolve_device(device if generator is None else generator.device)
        dtype = getattr(torch, cfg.param_dtype)
        self.cfg = cfg
        kinds = {"attn": Block, "mamba": MambaBlock, "rwkv": RWKVBlock}
        self.blocks = nn.ModuleList(
            kinds[kind](cfg, dtype, dev, generator, layer=i)
            for i, kind in enumerate(cfg.layer_kinds()))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype, device=dev))
        vlm, audio = cfg.family == "vlm", cfg.family == "audio"
        if cfg.input_kind == "tokens" or vlm:
            if generator is not None:
                embed = torch.randn((cfg.vocab_padded, cfg.d_model), generator=generator,
                                    device=dev) * cfg.d_model**-0.5
                embed = embed.to(dtype)
            else:
                embed = torch.empty((cfg.vocab_padded, cfg.d_model), dtype=dtype, device=dev)
            self.embed = nn.Parameter(embed)
            if not cfg.tie_embeddings:
                w = dense_weight(generator, cfg.d_model, cfg.vocab_padded, dtype, dev)
                self.lm_head = nn.Parameter(w)
        if cfg.input_kind == "embeddings" or vlm:
            w = dense_weight(generator, cfg.embed_in_dim, cfg.d_model, dtype, dev)
            self.in_proj = nn.Parameter(w)
            if audio:
                w = dense_weight(generator, cfg.d_model, cfg.vocab_padded, dtype, dev)
                self.lm_head = nn.Parameter(w)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Transformer:
    """A model with weights drawn on ``device`` from ``torch.Generator(seed)``."""
    dev = resolve_device(device)
    return Transformer(cfg, generator=torch.Generator(device=dev).manual_seed(seed))


def _embed(tokens, table):
    """Token embedding.  On a mesh, a lookup on each rank's vocabulary
    shard (ids outside it give zeros), summed over ``model``: DTensor's
    own masked partial for a sharded table cannot take a partial gradient
    back."""
    if not is_dtensor(table):
        return F.embedding(tokens.long(), table)
    from torch.distributed.tensor import Partial

    mesh = table.device_mesh
    if table.shape[0] % mesh_shape_of(mesh).get("model", 1):
        return local_region(lambda t, w: F.embedding(t.long(), w), (tokens, table),
                            (DP_HIDDEN[:2], (None, None)), outs=(0,))
    first = shard_start(mesh, "model", table.shape[0])

    def lookup(t, w):
        ids = t.long() - first
        inside = (ids >= 0) & (ids < w.shape[0])
        out = F.embedding(torch.where(inside, ids, 0), w)
        return out * inside[..., None].to(out.dtype)

    tok_pl = local_placements(tokens, mesh, DP_HIDDEN[:2])
    out_pl = [Partial() if name == "model" else pl
              for name, pl in zip(mesh.mesh_dim_names, tok_pl)]
    return local_region(lookup, (tokens, table), (DP_HIDDEN[:2], ("model", None)),
                        outs=(out_pl,))


def _pin_hidden(x):
    """Hidden states on a mesh: batch on dp, the rest replicated.  The
    vocab-sharded embedding's partial sum (and the column-parallel
    ``in_proj``'s shards) are resolved here, once, before any block."""
    return constraint(x, *DP_HIDDEN)


def embed_inputs(model: Transformer, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """The batch -> hidden states (B, S, D): token ids (B, S) embedded in the
    parameter dtype; a VLM's patches (B, n_patches, embed_in_dim) projected
    in the compute dtype, cast to the token embedding's dtype and put in
    front of its text; an encoder's frames (B, S, embed_in_dim) projected
    in the compute dtype."""
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.family == "vlm":
        tok = _pin_hidden(_embed(batch["tokens"], model.embed))
        patches = _pin_hidden(batch["patches"].to(cdt) @ model.in_proj.to(cdt))
        return torch.cat([patches.to(tok.dtype), tok], dim=1)
    if cfg.input_kind == "embeddings":
        return _pin_hidden(batch["embeds"].to(cdt) @ model.in_proj.to(cdt))
    return _pin_hidden(_embed(batch["tokens"], model.embed))


def input_shape(cfg: ModelConfig, batch: dict) -> tuple[int, int]:
    """(B, S) of the hidden states a batch of ``cfg``'s input kind makes:
    a VLM's S counts its patches and its text."""
    if cfg.family == "vlm":
        return batch["tokens"].shape[0], batch["tokens"].shape[1] + batch["patches"].shape[1]
    if cfg.input_kind == "embeddings":
        return tuple(batch["embeds"].shape[:2])
    return tuple(batch["tokens"].shape)


def unembed(model: Transformer, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Logits (..., vocab_padded) in the compute dtype; pad-vocab columns at -1e30."""
    cdt = getattr(torch, cfg.compute_dtype)
    h = h.to(cdt)
    if cfg.tie_embeddings:
        logits = h @ model.embed.to(cdt).T
    else:
        logits = h @ model.lm_head.to(cdt)
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.where(torch.arange(cfg.vocab_padded, device=h.device) < cfg.vocab_size,
                          0.0, -1e30).to(logits.dtype)
        logits = logits + pad
    return logits


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the unbatched matrix products' outputs and
    recompute the rest (the batched attention products included), as the
    reference's ``checkpoint_dots_with_no_batch_dims``."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _rematted(fn, remat: str):
    """``fn`` (x -> x) under the reference's remat policy: ``none``,
    ``full`` (recompute the whole block in the backward) or ``dots``."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat must be none, dots or full, got {remat!r}")


def _run_blocks(model, cfg, x, *, state=None, use_flash=False, remat="none", wkv_kernel=True):
    """The blocks in layer order, each with its own entry of ``state``;
    ``use_flash`` selects the attention kernels, ``wkv_kernel`` the WKV6
    kernel of the RWKV blocks (the reference ignores ``use_flash`` there).
    Without a state each block runs under ``remat``, as the reference remats
    each period group.  Returns (x, the MoE layers' aux summed, float32)."""
    aux = torch.zeros((), device=x.device)
    for i, block in enumerate(model.blocks):
        if state is None:
            run = functools.partial(block, cfg=cfg, use_flash=use_flash, wkv_kernel=wkv_kernel)
            x, a = _rematted(lambda h, run=run: run(h)[::2], remat)(x)
        else:
            x, state.layers[i], a = block(x, state.layers[i], cfg=cfg, pos=state.pos,
                                          use_flash=use_flash, wkv_kernel=wkv_kernel)
        if a is not None:
            aux = aux + a
    return x, aux


def forward(model: Transformer, cfg: ModelConfig, batch: dict, *, use_flash=False,
            remat="none", wkv_kernel=True, return_hidden=False):
    """Full forward -> (logits (B, S, V), aux), or (hidden, aux); aux is
    the MoE layers' Switch losses summed (0 without MoE).  Records a graph
    when autograd is on; the train step passes ``wkv_kernel=False`` (the
    kernels have no backward)."""
    x = embed_inputs(model, cfg, batch)
    x, aux = _run_blocks(model, cfg, x, use_flash=use_flash, remat=remat,
                         wkv_kernel=wkv_kernel)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    if return_hidden:
        return x, aux
    return unembed(model, cfg, x), aux


def loss_fn(model: Transformer, cfg: ModelConfig, batch: dict, *, use_flash=False,
            remat="none", wkv_kernel=True, logits_chunk: int = 0) -> torch.Tensor:
    """Next-token LM loss (a VLM's on its text positions only: the patches
    are prefix context), or an encoder's per-frame loss against
    ``labels`` with -100 masked; plus ``router_aux_weight`` times the
    summed aux with MoE.  ``logits_chunk > 0`` computes logits and the
    loss in sequence chunks of that size (never the full (B, S, V) logits)."""
    h, aux = forward(model, cfg, batch, use_flash=use_flash, remat=remat,
                     wkv_kernel=wkv_kernel, return_hidden=True)
    if cfg.causal:
        if cfg.family == "vlm":
            h = h[:, batch["patches"].shape[1]:]
        labels = batch["tokens"][:, 1:].long()
        h = h[:, :-1]
    else:
        labels = batch["labels"].long()
    S = h.shape[1]
    if not (logits_chunk and S > logits_chunk):
        loss = cross_entropy_loss(unembed(model, cfg, h), labels)
    else:
        total = torch.zeros((), device=h.device)
        count = torch.zeros((), dtype=torch.int64, device=h.device)
        for s0 in range(0, S, logits_chunk):
            lc = labels[:, s0:s0 + logits_chunk]
            n = (lc != -100).sum()
            total = total + cross_entropy_loss(
                unembed(model, cfg, h[:, s0:s0 + logits_chunk]), lc) * torch.clamp(n, min=1)
            count = count + n
        loss = total / torch.clamp(count, min=1)
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux
    return loss


@dataclasses.dataclass
class DecodeState:
    """Per layer, that block's state: the attention block's (k, v) cache,
    each (B, max_len, n_kv, hd), the Mamba block's (``ssm.mamba_state_init``)
    or the RWKV block's (``ssm.rwkv_state_init``); and the write position
    ``pos`` (a host int; tokens appended so far)."""

    layers: list
    pos: int = 0


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      cache_dtype=torch.bfloat16, device="cuda") -> DecodeState:
    """Zero caches and states; RWKV's carried tokens and Mamba's conv tail
    in ``cache_dtype``, their recurrent states in float32."""
    check_supported(cfg)
    dev = resolve_device(device)
    init = {"attn": lambda: init_cache(cfg, batch, max_len, cache_dtype, dev),
            "mamba": lambda: mamba_state_init(cfg, batch, cache_dtype, dev),
            "rwkv": lambda: rwkv_state_init(cfg, batch, cache_dtype, dev)}
    return DecodeState([init[cfg.block_pattern[i % cfg.pattern_period]]()
                        for i in range(cfg.n_layers)])


@torch.no_grad()
def decode_step(model: Transformer, cfg: ModelConfig, state: DecodeState, batch: dict, *,
                use_flash=False):
    """Append S new positions (S = 1 to decode) -> (logits (B, S, V), state);
    a VLM's decode batch carries an empty (B, 0, embed_in_dim) patch prefix.

    The caches are written in place and the RWKV and Mamba states replaced;
    the returned state is ``state`` with ``pos`` advanced by S.
    """
    x = embed_inputs(model, cfg, batch)
    x, _ = _run_blocks(model, cfg, x, state=state, use_flash=use_flash)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    logits = unembed(model, cfg, x)
    state.pos += x.shape[1]
    return logits, state


def init_sharded_decode_state(cfg: ModelConfig, batch: int, max_len: int, mesh,
                              cache_dtype=torch.bfloat16, device="cuda") -> DecodeState:
    """``init_decode_state`` laid out on ``mesh`` by the reference's
    ``decode_state_specs`` (caches: batch on dp, kv heads on ``model``, or
    the sequence where the heads do not divide); each rank makes only its
    own shards."""
    from repro_torch.sharding import layout, rules

    like = init_decode_state(cfg, batch, max_len, cache_dtype, device="meta")
    specs = rules.decode_state_specs(like.layers, rules.mesh_axes(mesh),
                                     rules.mesh_shape_of(mesh))
    return DecodeState(layout.zeros_state(like.layers, mesh, specs, resolve_device(device)))


def prefill(model: Transformer, cfg: ModelConfig, batch: dict, max_len: int, *,
            use_flash=False, cache_dtype=torch.bfloat16):
    """Process the whole prompt: (last-token logits (B, 1, V), filled state).
    Under an ambient mesh the state is ``init_sharded_decode_state``'s."""
    B, _ = input_shape(cfg, batch)
    dev = model.final_norm.device
    mesh = current_mesh()
    if mesh is None:
        state = init_decode_state(cfg, B, max_len, cache_dtype, dev)
    else:
        state = init_sharded_decode_state(cfg, B, max_len, mesh, cache_dtype, dev)
    logits, state = decode_step(model, cfg, state, batch, use_flash=use_flash)
    return logits[:, -1:], state


__all__ = [
    "Transformer", "Block", "MambaBlock", "RWKVBlock", "FFN", "DecodeState", "check_supported", "init_params",
    "embed_inputs", "input_shape", "unembed", "forward", "loss_fn", "init_decode_state",
    "decode_step", "prefill", "init_sharded_decode_state",
]
