"""Plain PyTorch versions of the WKV6 recurrence (``csrc/wkv6.cu``).

Per head, with S in R^{hs x hs}:

    out_t = r_t @ (S_{t-1} + (u * k_t) v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T

:func:`wkv6_ref` is the step scan of ``repro.kernels.rwkv6.ref``.
:func:`wkv6_chunked_ref` is the chunked form the model path runs, a loop of
:func:`wkv6_chunk` (the counterpart of ``repro.models.ssm._rwkv_chunk``):
parallel within a chunk, every decay factor the exp of a non-positive
difference of cumulative logs, so no ratio of cumulative products can
overflow however strong the decay.  The kernel is held against it.
"""

from __future__ import annotations

import torch

#: the reference's chunk length (``repro.kernels.rwkv6.kernel.DEFAULT_CHUNK``)
DEFAULT_CHUNK = 64


def wkv6_ref(r, k, v, w, u, S0=None):
    """r, k, v, w (B, T, H, hs); u (H, hs); S0 (B, H, hs, hs) or None.

    Returns (out (B, T, H, hs) float32, S_T (B, H, hs, hs) float32).
    """
    B, T, H, hs = r.shape
    r, k, v, w = (x.float() for x in (r, k, v, w))
    u = u.float()
    S = torch.zeros((B, H, hs, hs), device=r.device) if S0 is None else S0.float()
    outs = []
    for t in range(T):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], S + u[None, :, :, None] * kv))
        S = S * w[:, t, ..., None] + kv
    out = torch.stack(outs, dim=1) if outs else torch.zeros_like(r)
    return out, S


def wkv6_chunk(S0, r, k, v, w, u):
    """One chunk, parallel within it: S0 (B, H, hs, hs) float32; r, k, v, w
    (B, C, H, hs); u (H, hs) float32.  Returns (out (B, C, H, hs) float32, S_C)."""
    C = r.shape[1]
    logw = torch.log(torch.clamp(w.float(), 1e-8, 1.0))
    logD = torch.cumsum(logw, dim=1)                  # (B, C, H, hs), <= 0
    logDm1 = logD - logw                              # log D_{j-1}, D_0 = 1
    r32, k32, v32 = r.float(), k.float(), v.float()
    # inter-chunk: out_q += (r_q * D_{q-1}) @ S0
    out = torch.einsum("bchk,bhkv->bchv", r32 * torch.exp(logDm1), S0)
    # intra-chunk: att[q, d] = sum_c r[q,c] k[d,c] exp(logDm1[q,c] - logD[d,c])
    pair = torch.exp(torch.clamp(logDm1[:, :, None] - logD[:, None, :], max=0.0))
    att = torch.einsum("bqhc,bdhc,bqdhc->bhqd", r32, k32, pair)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device), diagonal=-1)
    att = torch.where(tri, att, 0.0)
    out = out + torch.einsum("bhqd,bdhv->bqhv", att, v32)
    # bonus diagonal: out_q += (r_q . (u * k_q)) v_q
    bonus = torch.sum(r32 * (u[None, None] * k32), dim=-1)
    out = out + bonus[..., None] * v32
    # state: S_C = diag(D_C) S0 + sum_i diag(exp(logD_C - logD_i)) k_i v_i^T
    logD_C = logD[:, -1]
    decay = torch.exp(logD_C[:, None] - logD)
    S = S0 * torch.exp(logD_C)[..., None] + torch.einsum("bchk,bchv->bhkv", k32 * decay, v32)
    return out, S


def wkv6_chunked_ref(r, k, v, w, u, *, chunk: int = DEFAULT_CHUNK, state=None,
                     out_dtype=None):
    """r, k, v, w (B, T, H, hs); u (H, hs); ``state`` (B, H, hs, hs) float32
    or None (zeros).  Returns (out (B, T, H, hs) in ``out_dtype``, default
    r's dtype; S_T (B, H, hs, hs) float32).

    A ragged T is padded to whole chunks with w = 1 and r = k = v = 0, steps
    that leave the state unchanged, as the reference does.
    """
    B, T, H, hs = r.shape
    pad = (-T) % chunk
    if pad:
        fill = lambda x, value: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad), value=value)
        r, k, v, w = fill(r, 0.0), fill(k, 0.0), fill(v, 0.0), fill(w, 1.0)
    u = u.float()
    S = torch.zeros((B, H, hs, hs), device=r.device) if state is None else state.float()
    outs = []
    for c0 in range(0, T + pad, chunk):
        sl = slice(c0, c0 + chunk)
        out, S = wkv6_chunk(S, r[:, sl], k[:, sl], v[:, sl], w[:, sl], u)
        outs.append(out)
    out = torch.cat(outs, dim=1)[:, :T] if outs else torch.zeros((B, 0, H, hs), device=r.device)
    return out.to(out_dtype or r.dtype), S


__all__ = ["DEFAULT_CHUNK", "wkv6_chunk", "wkv6_chunked_ref", "wkv6_ref"]
