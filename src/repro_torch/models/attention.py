"""Grouped-query attention with RoPE, qk-norm, KV cache and the flash option.

Counterpart of ``repro.models.attention``.  ``use_flash=False`` is the plain
path (:func:`_sdpa`, the reference's einsum attention, which rounds the
logits and probabilities to bfloat16); ``use_flash=True`` is the deployment path:
every call goes through a hand-written kernel, ``flash_attention`` for the
full-sequence forward and ``decode_attention`` for prefill and decode steps
against the cache.  The reference's sharding pins have no counterpart on
one card.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, dense_weight, rmsnorm, rope_angles


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
        q = (xc @ self.wq.to(cdt)).reshape(B, S, cfg.n_heads, hd)
        k = (xc @ self.wk.to(cdt)).reshape(B, S, cfg.n_kv_heads, hd)
        v = (xc @ self.wv.to(cdt)).reshape(B, S, cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, self.q_norm, cfg.norm_eps)
            k = rmsnorm(k, self.k_norm, cfg.norm_eps)
        offset = 0 if cache_index is None else cache_index
        positions = torch.arange(S, device=x.device) + offset
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        if cache is not None:
            ck, cv = cache
            S_max = ck.shape[1]
            if S > S_max:
                raise ValueError(f"{S} new tokens do not fit a cache of {S_max}")
            start = min(cache_index, S_max - S)
            ck[:, start:start + S] = k.to(ck.dtype)
            cv[:, start:start + S] = v.to(cv.dtype)
            kv_len = cache_index + S
            if use_flash:
                out = decode_attention(q, ck.to(cdt), cv.to(cdt), kv_len)
            else:
                out = _sdpa(q, ck.to(cdt), cv.to(cdt), causal=True,
                            q_offset=cache_index, kv_valid_len=kv_len)
        else:
            if use_flash:
                out = flash_attention(q, k, v, causal=cfg.causal)
            else:
                out = _sdpa(q, k, v, causal=cfg.causal)
        out = out.reshape(B, S, cfg.n_heads * hd)
        return out @ self.wo.to(cdt), cache


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"):
    """(k, v) zeros, each (batch, max_len, n_kv, hd)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


__all__ = ["Attention", "init_cache"]
