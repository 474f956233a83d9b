"""Plain PyTorch versions of the WKV6 recurrence (``csrc/wkv6.cu``).

Per head, with S in R^{hs x hs}:

    out_t = r_t @ (S_{t-1} + (u * k_t) v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T

:func:`wkv6_ref` is the step scan of ``repro.kernels.rwkv6.ref``.
:func:`wkv6_chunked_ref` is the chunked form the model path runs, a loop of
:func:`wkv6_chunk` (the counterpart of ``repro.models.ssm._rwkv_chunk``):
parallel within a chunk, every decay factor the exp of a non-positive
difference of cumulative logs, so no ratio of cumulative products can
overflow however strong the decay.  The kernels are held against it.
:func:`wkv6_two_pass_ref` is the algorithm the two kernels run, written
plainly for the tests: chunk states first, then outputs with the sub-chunk
factorisation.
"""

from __future__ import annotations

import torch

#: the reference's chunk length (``repro.kernels.rwkv6.kernel.DEFAULT_CHUNK``)
DEFAULT_CHUNK = 64
#: steps of a chunk in the kernels (``csrc/wkv6.cu``), whatever chunk is named
KERNEL_CHUNK = 64
#: rows of a sub-chunk of ``wkv6_outputs``
SUB_CHUNK = 16


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
    """One chunk, parallel within it: S0 (B, H, hs, hs) and u (H, hs) in the
    precision to compute in (float32, or float64 for a yardstick); r, k, v,
    w (B, C, H, hs).  Returns (out (B, C, H, hs), S_C) in S0's dtype."""
    C, dtype = r.shape[1], S0.dtype
    logw = torch.log(torch.clamp(w.to(dtype), 1e-8, 1.0))
    logD = torch.cumsum(logw, dim=1)                  # (B, C, H, hs), <= 0
    logDm1 = logD - logw                              # log D_{j-1}, D_0 = 1
    r32, k32, v32 = r.to(dtype), k.to(dtype), v.to(dtype)
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
                     out_dtype=None, precision=torch.float32):
    """r, k, v, w (B, T, H, hs); u (H, hs); ``state`` (B, H, hs, hs) float32
    or None (zeros).  Returns (out (B, T, H, hs) in ``out_dtype``, default
    r's dtype; S_T (B, H, hs, hs) float32).

    A ragged T is padded to whole chunks with w = 1 and r = k = v = 0, steps
    that leave the state unchanged, as the reference does.  ``precision``
    is the dtype computed in: float32, or float64 for a yardstick of the
    float32 versions where cumulative logs are large (w near its clamp),
    its results rounded once to the returned dtypes.
    """
    B, T, H, hs = r.shape
    pad = (-T) % chunk
    if pad:
        fill = lambda x, value: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad), value=value)
        r, k, v, w = fill(r, 0.0), fill(k, 0.0), fill(v, 0.0), fill(w, 1.0)
    u = u.to(precision)
    S = (torch.zeros((B, H, hs, hs), dtype=precision, device=r.device) if state is None
         else state.to(precision))
    outs = []
    for c0 in range(0, T + pad, chunk):
        sl = slice(c0, c0 + chunk)
        out, S = wkv6_chunk(S, r[:, sl], k[:, sl], v[:, sl], w[:, sl], u)
        outs.append(out)
    out = torch.cat(outs, dim=1)[:, :T] if outs else torch.zeros((B, 0, H, hs), device=r.device)
    return out.to(out_dtype or r.dtype), S.float()


def wkv6_two_pass_ref(r, k, v, w, u, *, state=None, out_dtype=None):
    """The kernels' algorithm: same arguments and results as
    :func:`wkv6_chunked_ref`, in chunks of ``KERNEL_CHUNK`` steps.

    Pass 1 (``wkv6_states``) walks the chunks and keeps the state entering
    each; a chunk's update sums its two 32-step halves, each decayed to its
    own last step, the first then by the second half's decay.  Pass 2
    (``wkv6_outputs``), all chunks at once: ``(r * D_{q-1}) S_in`` plus
    ``A V``, where ``A`` holds the intra-chunk weights below the diagonal
    and the bonus ``r[q] . (u * k[q])`` on it.  A block of ``SUB_CHUNK`` rows
    takes the keys of its chunk before it as one product, with ``ref =
    logD`` of the row before the block: ``(r * exp(logDm1 - ref)) (k *
    exp(ref - logD))^T``, both exponents <= 0; inside the block its second
    8 rows take its first 8 keys the same way, and the two 8 x 8 blocks on
    the diagonal take exact pair exps.
    """
    B, T, H, hs = r.shape
    C = KERNEL_CHUNK
    out_dtype = out_dtype or r.dtype
    n = -(-T // C)
    pad = n * C - T
    if pad:
        fill = lambda x, value: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad), value=value)
        r, k, v, w = fill(r, 0.0), fill(k, 0.0), fill(v, 0.0), fill(w, 1.0)
    # (B, H, n, C, hs) float32
    r, k, v, w = (x.float().reshape(B, n, C, H, hs).permute(0, 3, 1, 2, 4) for x in (r, k, v, w))
    u = u.float()
    logw = torch.log(torch.clamp(w, 1e-8, 1.0))
    logD = torch.cumsum(logw, dim=3)
    logDm1 = logD - logw
    logD_C = logD[..., -1, :]                                       # (B, H, n, hs)

    # Pass 1: the state entering each chunk.
    halves = []
    for lo in (0, C // 2):
        end = logD[..., lo + C // 2 - 1, None, :]
        kd = k[..., lo:lo + C // 2, :] * torch.exp(end - logD[..., lo:lo + C // 2, :])
        halves.append(torch.einsum("bhnck,bhncv->bhnkv", kd, v[..., lo:lo + C // 2, :]))
    U = torch.exp(logD_C - logD[..., C // 2 - 1, :])[..., None] * halves[0] + halves[1]
    S = torch.zeros((B, H, hs, hs), device=r.device) if state is None else state.float()
    entering = []
    for i in range(n):
        entering.append(S)
        S = torch.exp(logD_C[:, :, i])[..., None] * S + U[:, :, i]
    S_in = torch.stack(entering, dim=2) if entering else U

    # Pass 2: every chunk's outputs from its entering state.
    out = torch.einsum("bhnck,bhnkv->bhncv", r * torch.exp(logDm1), S_in)
    A = torch.zeros((B, H, n, C, C), device=r.device)
    for size, parent in ((SUB_CHUNK, C), (SUB_CHUNK // 2, SUB_CHUNK)):
        for lo in range(0, C, size):
            p0 = lo - lo % parent
            if lo == p0:
                continue
            ref = logD[..., lo - 1, None, :]
            rq = r[..., lo:lo + size, :] * torch.exp(logDm1[..., lo:lo + size, :] - ref)
            kd = k[..., p0:lo, :] * torch.exp(ref - logD[..., p0:lo, :])
            A[..., lo:lo + size, p0:lo] = torch.einsum("bhnqc,bhndc->bhnqd", rq, kd)
    for lo in range(0, C, SUB_CHUNK // 2):
        rows = slice(lo, lo + SUB_CHUNK // 2)
        pair = torch.exp(torch.clamp(logDm1[..., rows, None, :] - logD[..., None, rows, :],
                                     max=0.0))
        diag = torch.einsum("bhnqc,bhndc,bhnqdc->bhnqd", r[..., rows, :], k[..., rows, :], pair)
        bonus = torch.sum(r[..., rows, :] * u[None, :, None, None] * k[..., rows, :], dim=-1)
        A[..., rows, rows] = torch.tril(diag, diagonal=-1) + torch.diag_embed(bonus)
    out = out + torch.einsum("bhnqd,bhndv->bhnqv", A, v)
    out = out.permute(0, 2, 3, 1, 4).reshape(B, n * C, H, hs)[:, :T]
    return out.to(out_dtype), S


__all__ = ["DEFAULT_CHUNK", "KERNEL_CHUNK", "SUB_CHUNK", "wkv6_chunk", "wkv6_chunked_ref",
           "wkv6_ref", "wkv6_two_pass_ref"]
