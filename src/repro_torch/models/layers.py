"""Shared layers: plain functions on tensors; counterpart of ``repro.models.layers``.

Numerics follow the reference: RMSNorm in float32 and cast back, RoPE on
the half-split layout (not interleaved) with float32 angles, FFN products
in the compute dtype, cross-entropy in float32.  Initialisers draw from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding.context import (
    constraint,
    is_dtensor,
    local_placements,
    local_region,
    shard_start,
)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32, cast back to the input dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def init_dense(generator: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    """(d_in, d_out) normal weights scaled by ``d_in ** -0.5`` (the reference's
    ``init_dense``), drawn in float32 on the generator's device."""
    scale = scale if scale is not None else d_in**-0.5
    w = torch.randn((d_in, d_out), generator=generator, device=generator.device)
    return (w * scale).to(dtype)


def dense_weight(generator: torch.Generator | None, d_in: int, d_out: int, dtype,
                 device) -> torch.Tensor:
    """``init_dense`` from ``generator``, or uninitialised memory on ``device``
    (for ``load_state_dict``) when there is none."""
    if generator is None:
        return torch.empty((d_in, d_out), dtype=dtype, device=device)
    return init_dense(generator, d_in, d_out, dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """positions (...,) -> cos, sin (..., head_dim/2), float32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, n_heads, head_dim); cos/sin (..., S, head_dim/2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous.  Attention's backward
    hands the head split a strided gradient; a plain tensor's ``reshape``
    backward copies it, but a DTensor's keeps the strided local shard, and
    DTensor's ``view`` of it then fails in the projection's backward.
    Copying it here, where the plain path copies, keeps every layout (and
    so every result on the card) the plain path's."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if not is_dtensor(g):
            return g.contiguous()
        from torch.distributed.tensor import DTensor

        # a DTensor is contiguous by its global strides, whatever its shard's
        return DTensor.from_local(g.to_local().contiguous(), g.device_mesh, g.placements,
                                  run_check=False, shape=g.shape, stride=g.stride())


def split_heads(t: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    """(B, S, n_heads * hd) -> (B, S, n_heads, hd).  A DTensor whose last
    axis is sharded over more ranks than the heads divide into is first
    gathered along it (the heads then shard no further)."""
    B, S, _ = t.shape
    if not is_dtensor(t):
        return t.reshape(B, S, n_heads, hd)
    from torch.distributed.tensor import Replicate

    mesh = t.device_mesh
    n = 1
    for size, pl in zip(mesh.shape, t.placements):
        if pl.is_shard(2):
            n *= size
    if n_heads % n:
        t = t.redistribute(mesh, [Replicate() if pl.is_shard(2) else pl for pl in t.placements])
    return _ContiguousGrad.apply(t.reshape(B, S, n_heads, hd))


class _GradAsForward(torch.autograd.Function):
    """Identity whose gradient is laid out as the forward tensor was: e.g.
    a merged head axis that was replicated must get its gradient back
    replicated (a row-parallel product's backward shards it along the
    merged axis, which the head split cannot undo)."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def grad_as_forward(t: torch.Tensor) -> torch.Tensor:
    """``t``; on a DTensor its gradient is laid out as ``t`` is (DTensor
    may otherwise scatter a partial gradient along an axis that a later
    reshape cannot split)."""
    return _GradAsForward.apply(t) if is_dtensor(t) else t


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, H * hd); on a DTensor the gradient comes back
    laid out as the merged tensor was."""
    B, S, H, hd = t.shape
    return grad_as_forward(t.reshape(B, S, H * hd))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s definition, x * 1 / (1 + exp(-x)), op by op in the
    input dtype: the reference rounds to bfloat16 after each op, and
    ``F.silu`` (one rounding) differs from it by one bfloat16 ulp in about
    a third of the elements."""
    return x * (1 / (1 + torch.exp(-x)))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as the reference computes it, 1 / (1 + exp(-x)) op
    by op in the input dtype (``torch.sigmoid`` rounds once and differs by
    one bfloat16 ulp in about a third of the elements)."""
    return 1 / (1 + torch.exp(-x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` op by op in the input dtype, its
    constants first rounded to that dtype, as the reference computes it."""
    def const(v: float) -> float:
        return torch.tensor(v, dtype=x.dtype).item()

    inner = (x + x * x * x * const(0.044715)) * const(math.sqrt(2 / math.pi))
    return x * ((torch.tanh(inner) + 1.0) * 0.5)


def swiglu(x, w_gate, w_up, w_down, compute_dtype=torch.bfloat16):
    x = x.to(compute_dtype)
    g = silu(x @ w_gate.to(compute_dtype))
    u = x @ w_up.to(compute_dtype)
    return (g * u) @ w_down.to(compute_dtype)


def geglu(x, w_gate, w_up, w_down, compute_dtype=torch.bfloat16):
    x = x.to(compute_dtype)
    g = gelu(x @ w_gate.to(compute_dtype))
    u = x @ w_up.to(compute_dtype)
    return (g * u) @ w_down.to(compute_dtype)


def ffn_apply(x, weights: dict, ffn_type: str, compute_dtype=torch.bfloat16):
    """The FFN of ``ffn_type`` on ``weights`` (names as in the reference)."""
    if ffn_type == "swiglu":
        return swiglu(x, weights["w_gate"], weights["w_up"], weights["w_down"],
                      compute_dtype)
    if ffn_type == "geglu":
        return geglu(x, weights["w_gate"], weights["w_up"], weights["w_down"],
                     compute_dtype)
    if ffn_type in ("relu", "gelu"):
        x = x.to(compute_dtype)
        act = F.relu if ffn_type == "relu" else gelu
        h = act(x @ weights["w_up"].to(compute_dtype))
        return h @ weights["w_down"].to(compute_dtype)
    raise ValueError(ffn_type)


def ffn_shapes(d_model: int, d_ff: int, ffn_type: str) -> dict:
    """Weight name -> (d_in, d_out) of an FFN of ``ffn_type``."""
    if ffn_type in ("swiglu", "geglu"):
        return {"w_gate": (d_model, d_ff), "w_up": (d_model, d_ff),
                "w_down": (d_ff, d_model)}
    if ffn_type in ("relu", "gelu"):
        return {"w_up": (d_model, d_ff), "w_down": (d_ff, d_model)}
    raise ValueError(ffn_type)


def _vocab_sharded(logits) -> bool:
    """Whether ``logits`` is a DTensor split along its last (vocabulary)
    axis over more than one rank."""
    if not is_dtensor(logits):
        return False
    mesh = logits.device_mesh
    last = logits.ndim - 1
    return any(pl.is_shard(last) and n > 1 for pl, n in zip(logits.placements, mesh.shape))


def _sharded_terms(logits, labels):
    """(logsumexp, the gold logit) of vocabulary-sharded logits without
    gathering them: the max and the sum of exponentials reduce over the
    shards, and each rank picks the gold logits its shard holds (a partial
    sum over ``model``)."""
    from torch.distributed.tensor import Partial

    m = constraint(logits.detach().amax(dim=-1), ("pod", "data"), None)
    logz = torch.log(constraint(torch.exp(logits - m[..., None]).sum(dim=-1),
                                ("pod", "data"), None)) + m
    mesh = logits.device_mesh
    first = shard_start(mesh, "model", logits.shape[-1])

    def pick(x, t):
        ids = t - first
        inside = (ids >= 0) & (ids < x.shape[-1])
        got = torch.gather(x, -1, torch.where(inside, ids, 0)[..., None])[..., 0]
        return torch.where(inside, got, 0.0)

    spec = (("pod", "data"), None, "model")
    lab_pl = local_placements(labels, mesh, spec[:2])
    out_pl = [Partial() if name == "model" else pl
              for name, pl in zip(mesh.mesh_dim_names, lab_pl)]
    gold = local_region(pick, (logits, labels), (spec, spec[:2]), outs=(out_pl,))
    return logz, constraint(gold, ("pod", "data"), None)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       ignore_index: int = -100, z_loss: float = 0.0) -> torch.Tensor:
    """Token-mean softmax cross-entropy in float32; ``ignore_index`` masked."""
    logits = logits.float()
    mask = labels != ignore_index
    safe = torch.where(mask, labels, 0).long()
    if _vocab_sharded(logits):
        logz, gold = _sharded_terms(logits, safe)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = logz - gold
    if z_loss:
        nll = nll + z_loss * logz**2
    nll = torch.where(mask, nll, 0.0)
    denom = torch.clamp(mask.sum(), min=1)
    return nll.sum() / denom


__all__ = [
    "rmsnorm", "init_dense", "dense_weight", "rope_angles", "apply_rope", "silu", "sigmoid", "gelu", "swiglu",
    "geglu", "ffn_apply", "ffn_shapes", "cross_entropy_loss", "grad_as_forward", "merge_heads", "split_heads",
]
