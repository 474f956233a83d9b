"""Public wrapper of the Hopper segment-reduce kernel (``csrc/segment_reduce.cu``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_reduce.ref import segment_reduce_ref


def segment_reduce(keys: torch.Tensor, values: torch.Tensor, out=None,
                   addend: torch.Tensor | None = None):
    """keys/values (N, C) int32, rows sorted with a PAD_KEY tail, or (C,).

    Returns (out_keys, out_vals): each run's int32 sum at its first slot,
    (PAD_KEY, 0) elsewhere.  ``addend``, an optional (N,) int32 tensor (a
    scalar one for (C,)), is added to every run's sum of its row.  ``out``,
    an optional pair of int32 tensors of the operands' shape, receives the
    results, which are then returned: every slot is written, so it may
    hold anything before, and rows [s, s + N) of larger (R, C) buffers are
    a contiguous view to pass.  CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream, or raise; meta
    tensors get shape-only outputs of the same shapes.
    ``segment_reduce.launches`` counts kernel launches.
    """
    if keys.dim() == 1:
        ok, ov = segment_reduce(
            keys[None], values[None],
            None if out is None else tuple(o[None] for o in out),
            None if addend is None else addend.reshape(1))
        return ok[0], ov[0]
    if keys.device.type == "cpu" and values.device.type == "cpu":
        got = segment_reduce_ref(keys, values, addend)
        if out is None:
            return got
        for o, g in zip(out, got):
            o.copy_(g)
        return tuple(out)
    if keys.device.type == "meta" and values.device.type == "meta":
        # Shape only (the cost estimator's pass): a copy reads each operand
        # once and writes each result once, as the kernel moves them.
        if out is None:
            return keys.clone(), values.clone()
        out[0].copy_(keys)
        out[1].copy_(values)
        return tuple(out)
    _build.check_rows("segment_reduce", keys, values)
    if out is None:
        out = (torch.empty_like(keys), torch.empty_like(values))
    else:
        _build.check_rows("segment_reduce", *out)
        if out[0].shape != keys.shape or out[0].device != keys.device:
            raise ValueError(
                f"segment_reduce: out must be {tuple(keys.shape)} on {keys.device}, got "
                f"{tuple(out[0].shape)} on {out[0].device}")
    n_rows, n_cols = keys.shape
    if addend is not None and (addend.dtype != torch.int32 or addend.shape != (n_rows,)
                               or addend.device != keys.device
                               or not addend.is_contiguous()):
        raise ValueError(
            f"segment_reduce: addend must be a contiguous ({n_rows},) int32 tensor on "
            f"{keys.device}, got "
            f"{tuple(addend.shape)} {addend.dtype} on {addend.device}")
    lib = _build.load()
    scratch = torch.empty(lib.segment_reduce_scratch(n_rows, n_cols), dtype=torch.int64,
                          device=keys.device)
    with torch.cuda.device(keys.device), _build.launch_range("segment_reduce"):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.segment_reduce_launch(
            keys.data_ptr(), values.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            None if addend is None else addend.data_ptr(),
            scratch.data_ptr(), n_rows, n_cols, stream,
        )
    _build.raise_on_error(lib, "segment_reduce", code)
    segment_reduce.launches += 1
    return tuple(out)


segment_reduce.launches = 0


def row_key_sums(keys: torch.Tensor) -> torch.Tensor:
    """keys (N, C) int32, rows sorted with a PAD_KEY tail: each row's exact
    int64 key sum, PAD tail included, as ``keys.sum(dim=1)`` gives it.

    On the card a kernel reads only each row's live prefix (and the first
    key of each PAD-led tile), adding the tail as a count times PAD_KEY;
    CPU and meta tensors take ``keys.sum(dim=1)``.
    ``row_key_sums.launches`` counts kernel launches.
    """
    if keys.device.type in ("cpu", "meta"):
        return keys.sum(dim=1)
    _build.check_rows("row_key_sums", keys, keys)
    lib = _build.load()
    n_rows, n_cols = keys.shape
    sums = torch.empty(n_rows, dtype=torch.int64, device=keys.device)
    n_sms = torch.cuda.get_device_properties(keys.device).multi_processor_count
    with torch.cuda.device(keys.device), _build.launch_range("row_key_sums"):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.row_key_sums_launch(keys.data_ptr(), sums.data_ptr(), n_rows, n_cols,
                                       n_sms, stream)
    _build.raise_on_error(lib, "row_key_sums", code)
    row_key_sums.launches += 1
    return sums


row_key_sums.launches = 0
