"""Public wrapper of the Hopper segment-reduce kernel (``csrc/segment_reduce.cu``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_reduce.ref import segment_reduce_ref


def segment_reduce(keys: torch.Tensor, values: torch.Tensor):
    """keys/values (N, C) int32, rows sorted with a PAD_KEY tail, or (C,).

    Returns (out_keys, out_vals): each run's int32 sum at its first slot,
    (PAD_KEY, 0) elsewhere.  CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream, or raise; meta
    tensors get shape-only outputs of the same shapes.
    ``segment_reduce.launches`` counts kernel launches.
    """
    if keys.dim() == 1:
        ok, ov = segment_reduce(keys[None], values[None])
        return ok[0], ov[0]
    if keys.device.type == "cpu" and values.device.type == "cpu":
        return segment_reduce_ref(keys, values)
    if keys.device.type == "meta" and values.device.type == "meta":
        # Shape only (the cost estimator's pass): a copy reads each operand
        # once and writes each result once, as the kernel moves them.
        return keys.clone(), values.clone()
    _build.check_rows("segment_reduce", keys, values)
    lib = _build.load()
    out_k = torch.empty_like(keys)
    out_v = torch.zeros_like(values)
    n_rows, n_cols = keys.shape
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.segment_reduce_launch(
            keys.data_ptr(), values.data_ptr(), out_k.data_ptr(),
            out_v.data_ptr(), n_rows, n_cols, stream,
        )
    _build.raise_on_error(lib, "segment_reduce", code)
    segment_reduce.launches += 1
    return out_k, out_v


segment_reduce.launches = 0
