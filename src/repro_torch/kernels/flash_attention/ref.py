"""Plain PyTorch version of the flash-attention kernel (``csrc/flash_attention.cu``).

The contract of the Pallas kernel it replaces, computed in one pass: float32
logits and softmax, masked logits at -1e30, masked probabilities exactly 0,
``p`` kept in float32 into the P.V product, the sum clamped at 1e-30 (a row
with no visible key gives 0), the result cast to the input dtype.  The
reference's ``attention_ref`` rounds ``p`` to the input dtype before P.V
instead; in bfloat16 the two differ within its tests' 5e-2.

The kernel's bfloat16 path rounds ``p`` once to bfloat16 into P.V, as
``attention_ref`` does, and sums ``l`` over the float32 ``p`` (its remainder
product, which kept 16 bits of ``p``, was dropped; PERF.md gives the
numbers); it is held against this version to 5e-2 elementwise and 1e-2 per
row.  Its float32 path keeps ``p`` float32, as here, and is held to 2e-5.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def grouped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      visible: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B, Sq, Hq, hd); k, v (B, Sk, n_kv, hd); ``visible`` (Sq, Sk) bool.

    Query head h reads kv head h // G, without repeating K/V.
    """
    B, Sq, Hq, hd = q.shape
    n_kv = k.shape[2]
    qg = q.float().reshape(B, Sq, n_kv, Hq // n_kv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    s = torch.where(visible, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(visible, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float()) / torch.clamp(l, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        sm_scale: float | None = None) -> torch.Tensor:
    """q (B, Sq, Hq, hd); k, v (B, Sk, n_kv, hd) -> (B, Sq, Hq, hd).

    Causal masks ``qpos >= kpos`` from position 0 for both.
    """
    Sq, Sk, hd = q.shape[1], k.shape[1], q.shape[3]
    scale = sm_scale if sm_scale is not None else hd**-0.5
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    visible = qpos >= kpos if causal else torch.ones((Sq, Sk), dtype=torch.bool,
                                                    device=q.device)
    return grouped_attention(q, k, v, visible, scale)
