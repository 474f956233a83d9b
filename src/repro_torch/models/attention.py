"""Grouped-query attention with RoPE, qk-norm, KV cache and the flash option.

Counterpart of ``repro.models.attention``.  ``use_flash=False`` is the plain
path (:func:`_sdpa`, the reference's einsum attention, which rounds the
logits and probabilities to bfloat16); ``use_flash=True`` is the deployment path:
every call goes through a hand-written kernel, ``flash_attention`` for the
full-sequence forward and ``decode_attention`` for prefill and decode steps
against the cache.

On a mesh (``sharding.context.use_mesh``, DTensor weights) the
full-sequence path takes the reference's pins: q, k and v sharded by
heads on ``model`` when the kv heads divide it, else K/V by sequence.
The attention itself (the kernels, which take plain tensors, and
``_sdpa`` alike) then runs on each rank's local shards
(:func:`_local_attention`): K/V head-sharded on ``model``, or replicated
on it where the kv heads do not divide it (each rank then slicing the kv
heads its query heads read), and the output rebuilt with q's
placements.  A cache sharded by heads is written through its local
shard; one sharded by sequence (the specs' fallback) is written through
the local shard's slice of the new positions and gathered to be read.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (
    apply_rope,
    dense_weight,
    merge_heads,
    rmsnorm,
    rope_angles,
    split_heads,
)
from repro_torch.sharding.context import (
    constraint,
    current_mesh,
    is_dtensor,
    local_placements,
    shard_start,
)
from repro_torch.sharding.rules import mesh_shape_of

#: the dp axes of the production meshes (dropped where a mesh lacks one)
DP = ("pod", "data")


def _model_size(mesh) -> int:
    return mesh_shape_of(mesh).get("model", 1)


def _layout(t, mesh, spec):
    """``t`` redistributed to ``spec`` on ``mesh``, each assignment kept only
    where its dimension divides."""
    want = local_placements(t, mesh, spec)
    return t if tuple(t.placements) == tuple(want) else t.redistribute(mesh, want)


def _local_attention(fn, q, k, v, n_kv: int):
    """``fn(q, k, v)`` -> out on plain tensors; on DTensors, run on each
    rank's local shards: batch on dp, K/V heads on ``model`` when ``n_kv``
    divides it (q with them).  Else K/V are replicated on ``model`` and q
    stays sharded by heads where each rank's query heads read a whole
    number of kv heads (or share one), each rank slicing the kv heads its
    queries read; otherwise q is replicated too.  The output carries q's
    placements."""
    if not is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor import DTensor

    mesh = q.device_mesh
    m = _model_size(mesh)
    Hq = q.shape[2]
    G = Hq // n_kv
    kv_heads = "model" if n_kv % m == 0 else None
    q_heads = kv_heads
    if kv_heads is None and Hq % m == 0 and ((Hq // m) % G == 0 or G % (Hq // m) == 0):
        q_heads = "model"
    q = _layout(q, mesh, (DP, None, q_heads, None))
    k = _layout(k, mesh, (DP, None, kv_heads, None))
    v = _layout(v, mesh, (DP, None, kv_heads, None))
    if q_heads is not None and kv_heads is None and m > 1:
        from torch.distributed.tensor import Partial

        # each rank reads (and so takes the gradient of) its kv heads only
        grad_pl = [Partial() if name == "model" else pl
                   for name, pl in zip(mesh.mesh_dim_names, k.placements)]
        h0 = shard_start(mesh, "model", Hq)
        heads = slice(h0 // G, (h0 + Hq // m - 1) // G + 1)
        kl, vl = (t.to_local(grad_placements=grad_pl)[:, :, heads] for t in (k, v))
    else:
        kl, vl = k.to_local(), v.to_local()
    out = fn(q.to_local(), kl, vl)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)


def _seq_entry(cache):
    """The mesh axes that shard a cache's sequence axis, major first, or ()."""
    mesh = cache.device_mesh
    return tuple(name for name, pl in zip(mesh.mesh_dim_names, cache.placements)
                 if pl.is_shard(1))


def _write_cache(cache, new, start: int) -> None:
    """cache[:, start:start + S] = new, in place.  A DTensor cache is written
    through its local shard: the new entries are laid out as the cache
    (sharded by sequence: gathered, and each rank writes the part of the
    new positions its shard holds)."""
    if not is_dtensor(cache):
        cache[:, start:start + new.shape[1]] = new.to(cache.dtype)
        return
    mesh = cache.device_mesh
    seq_axes = _seq_entry(cache)
    local = cache.to_local()
    if not seq_axes:
        new = new.to(cache.dtype).redistribute(mesh, cache.placements).to_local()
        local[:, start:start + new.shape[1]] = new
        return
    keep = [pl if not pl.is_shard(1) else _replicate() for pl in cache.placements]
    new = new.to(cache.dtype).redistribute(mesh, keep).to_local()
    sizes = mesh_shape_of(mesh)
    shard = 0
    for name in seq_axes:  # linear index of this rank's sequence shard
        shard = shard * sizes[name] + mesh.get_local_rank(name)
    n = local.shape[1]
    lo, hi = max(start, shard * n), min(start + new.shape[1], (shard + 1) * n)
    if lo < hi:
        local[:, lo - shard * n:hi - shard * n] = new[:, lo - start:hi - start]


def _replicate():
    from torch.distributed.tensor import Replicate

    return Replicate()


def _gathered_cache(cache):
    """A DTensor cache sharded by sequence, gathered along it (the
    attention over it runs on whole sequences); otherwise as it is."""
    if not is_dtensor(cache) or not _seq_entry(cache):
        return cache
    keep = [pl if not pl.is_shard(1) else _replicate() for pl in cache.placements]
    return cache.redistribute(cache.device_mesh, keep)


def _sdpa(q, k, v, *, causal: bool, q_offset: int = 0, kv_valid_len=None):
    """Plain grouped-query attention, as the reference's ``_sdpa``.

    q (B, Sq, Hq, hd); k, v (B, Sk, n_kv, hd).  Logits in the input dtype,
    softmax in float32, probabilities rounded to the input dtype.
    ``kv_valid_len`` masks cache slots at or past it (decode mode).
    """
    B, Sq, Hq, hd = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(B, Sq, n_kv, Hq // n_kv, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * hd**-0.5
    Sk = k.shape[1]
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = None
    if causal:
        mask = qpos[:, None] >= kpos[None, :]
    if kv_valid_len is not None:
        vmask = (kpos < kv_valid_len)[None, :]
        mask = vmask if mask is None else mask & vmask
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, Hq, hd)


class Attention(nn.Module):
    """GQA self-attention of one block; weights (d_in, d_out) as in the reference."""

    def __init__(self, cfg, dtype, device, generator: torch.Generator | None = None):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
                  "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
        for name, (d_in, d_out) in shapes.items():
            w = dense_weight(generator, d_in, d_out, dtype, device)
            self.register_parameter(name, nn.Parameter(w))
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones(hd, dtype=dtype, device=device))
            self.k_norm = nn.Parameter(torch.ones(hd, dtype=dtype, device=device))

    def forward(self, x, *, cfg, cache=None, cache_index: int | None = None,
                use_flash: bool = False):
        """x (B, S, D).  ``cfg`` sets the compute (its shapes are the
        module's).  Without a cache: full self-attention (causal per cfg).

        With ``cache = (k, v)``, each (B, S_max, n_kv, hd), and the host int
        ``cache_index``: writes the S new entries at ``cache_index`` (in
        place; the start clamps to S_max - S, as ``dynamic_update_slice``
        does) and attends over the first ``cache_index + S`` slots.
        Returns (out, cache).
        """
        B, S, _ = x.shape
        hd = cfg.resolved_head_dim
        cdt = getattr(torch, cfg.compute_dtype)
        xc = x.to(cdt)
        q = split_heads(xc @ self.wq.to(cdt), cfg.n_heads, hd)
        k = split_heads(xc @ self.wk.to(cdt), cfg.n_kv_heads, hd)
        v = split_heads(xc @ self.wv.to(cdt), cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, self.q_norm, cfg.norm_eps)
            k = rmsnorm(k, self.k_norm, cfg.norm_eps)
        offset = 0 if cache_index is None else cache_index
        positions = torch.arange(S, device=x.device) + offset
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        n_kv = cfg.n_kv_heads
        if cache is not None:
            ck, cv = cache
            S_max = ck.shape[1]
            if S > S_max:
                raise ValueError(f"{S} new tokens do not fit a cache of {S_max}")
            start = min(cache_index, S_max - S)
            _write_cache(ck, k, start)
            _write_cache(cv, v, start)
            kv_len = cache_index + S
            rk, rv = _gathered_cache(ck), _gathered_cache(cv)
            if use_flash:
                fn = lambda q, k, v: decode_attention(q, k.to(cdt), v.to(cdt), kv_len)
            else:
                fn = lambda q, k, v: _sdpa(q, k.to(cdt), v.to(cdt), causal=True,
                                           q_offset=cache_index, kv_valid_len=kv_len)
            out = _local_attention(fn, q, rk, rv, n_kv)
        else:
            # The reference's pins for full-sequence self-attention: heads
            # on model when the kv heads divide it, else K/V by sequence
            # (its partitioner would all-reduce the float32 S^2 logits).
            mesh = current_mesh()
            if mesh is not None:
                if n_kv % _model_size(mesh) == 0:
                    q = constraint(q, DP, None, "model", None)
                    k = constraint(k, DP, None, "model", None)
                    v = constraint(v, DP, None, "model", None)
                else:
                    q = constraint(q, DP, None, None, None)
                    k = constraint(k, DP, "model", None, None)
                    v = constraint(v, DP, "model", None, None)
            if use_flash:
                fn = lambda q, k, v: flash_attention(q, k, v, causal=cfg.causal)
            else:
                fn = lambda q, k, v: _sdpa(q, k, v, causal=cfg.causal)
            out = _local_attention(fn, q, k, v, n_kv)
        return merge_heads(out) @ self.wo.to(cdt), cache


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"):
    """(k, v) zeros, each (batch, max_len, n_kv, hd)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


__all__ = ["Attention", "init_cache"]
