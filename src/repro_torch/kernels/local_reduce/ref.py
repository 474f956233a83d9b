"""Plain PyTorch version of the local reduce (the CUDA kernel's contract)."""

from __future__ import annotations

import torch

from repro_torch.kernels.segment_reduce.ref import PAD_KEY, run_heads_and_ids


def local_reduce_ref(keys: torch.Tensor, values: torch.Tensor):
    """keys/values (N, C) int32 (or (C,)), rows sorted, PAD_KEY = invalid.

    Returns (out_keys, out_vals): run i's key and sum at slot i, in
    ascending key order, then a (PAD_KEY, 0) tail.  A run's index is its
    slot, so the compaction is the same ``index_add_`` as the segment
    reduce, into a row with one spare column that takes the dead slots.
    """
    if keys.dim() == 1:
        ok, ov = local_reduce_ref(keys[None], values[None])
        return ok[0], ov[0]
    N, C = keys.shape
    valid, first, seg = run_heads_and_ids(keys)
    seg = torch.where(valid, seg, C)  # the spare column
    rows = torch.arange(N, device=keys.device)[:, None] * (C + 1)
    slot_k = (torch.where(first, seg, C) + rows).reshape(-1)
    slot_v = (seg + rows).reshape(-1)
    ck = torch.full((N * (C + 1),), PAD_KEY, dtype=keys.dtype, device=keys.device)
    ck[slot_k] = keys.reshape(-1)
    cv = torch.zeros(N * (C + 1), dtype=values.dtype, device=keys.device)
    cv.index_add_(0, slot_v, torch.where(valid, values, 0).reshape(-1))
    return ck.reshape(N, C + 1)[:, :C], cv.reshape(N, C + 1)[:, :C]
