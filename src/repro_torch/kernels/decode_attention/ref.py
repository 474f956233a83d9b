"""Plain PyTorch version of the flash-decode kernel (``csrc/decode_attention.cu``).

Same numerics as ``flash_attention_ref`` (float32 softmax, ``p`` float32 into
P.V, masked probabilities 0).  The reference's ``decode_attention_ref``
rounds ``p`` to the input dtype first; in bfloat16 the two differ within
its tests' 5e-2.  The kernel's bfloat16 path, like ``decode_attention_ref``,
rounds ``p`` once to bfloat16 into P.V (no remainder product; PERF.md
gives the numbers) and is held against this version to 5e-2 elementwise
and 1e-2 per row; its float32 path keeps ``p`` float32 and is held to
2e-5.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import grouped_attention


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, kv_len: int) -> torch.Tensor:
    """q (B, Sq, Hq, hd); caches (B, S_max, n_kv, hd); ``kv_len`` an int.

    Query qi sits at position kv_len - Sq + qi and sees the cache slots up
    to it (all S_max slots when kv_len > S_max).
    """
    Sq, S_max, hd = q.shape[1], k_cache.shape[1], q.shape[3]
    qpos = int(kv_len) - Sq + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(S_max, device=q.device)[None, :]
    return grouped_attention(q, k_cache, v_cache, kpos <= qpos, hd**-0.5)
