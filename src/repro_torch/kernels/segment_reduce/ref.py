"""Plain PyTorch version of the sorted segment reduce (the CUDA kernel's contract)."""

from __future__ import annotations

import torch

PAD_KEY = 2**31 - 1


def run_heads_and_ids(keys: torch.Tensor):
    """For (N, C) key-sorted, PAD_KEY-tailed rows: (valid, first, seg) where
    ``first`` flags each run's first slot and ``seg`` is every live slot's
    run index in its row (dead slots: C - 1)."""
    C = keys.shape[1]
    valid = keys != PAD_KEY
    first = valid.clone()
    first[:, 1:] &= keys[:, 1:] != keys[:, :-1]
    seg = torch.cumsum(first, dim=1, dtype=torch.int64) - 1
    return valid, first, torch.where(valid, seg, C - 1)


def segment_reduce_ref(keys: torch.Tensor, values: torch.Tensor,
                       addend: torch.Tensor | None = None):
    """keys/values (N, C) int32 (or (C,)), rows sorted, PAD_KEY = invalid;
    addend: optional (N,) int32 (a scalar for (C,)).

    Returns (out_keys, out_vals): each run's sum, plus its row's addend, at
    its first occurrence, (PAD_KEY, 0) elsewhere.  Head flags, ``cumsum``
    run ids, ``index_add_``.
    """
    if keys.dim() == 1:
        ok, ov = segment_reduce_ref(
            keys[None], values[None], None if addend is None else addend.reshape(1))
        return ok[0], ov[0]
    N, C = keys.shape
    valid, first, seg = run_heads_and_ids(keys)
    flat = (seg + torch.arange(N, device=keys.device)[:, None] * C).reshape(-1)
    agg = torch.zeros(N * C, dtype=values.dtype, device=keys.device)
    agg.index_add_(0, flat, torch.where(valid, values, 0).reshape(-1))
    sums = agg[flat].reshape(N, C)
    if addend is not None:
        sums = sums + addend.to(values.dtype)[:, None]
    out_keys = torch.where(first, keys, PAD_KEY)
    out_vals = torch.where(first, sums, 0)
    return out_keys, out_vals
