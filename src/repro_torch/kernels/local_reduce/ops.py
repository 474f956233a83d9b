"""Public wrapper of the Hopper local-reduce kernel (``csrc/local_reduce.cu``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.local_reduce.ref import local_reduce_ref
from repro_torch.kernels.segment_reduce.ref import PAD_KEY


def local_reduce(keys: torch.Tensor, values: torch.Tensor):
    """keys/values (N, C) int32, rows sorted with a PAD_KEY tail, or (C,).

    Returns (out_keys, out_vals) with each row's run sums front-packed in
    ascending key order and a (PAD_KEY, 0) tail.  CPU tensors take the
    plain version; CUDA tensors launch the kernel on the current stream,
    or raise; meta tensors get shape-only outputs of the same shapes.
    ``local_reduce.launches`` counts kernel launches.
    """
    if keys.dim() == 1:
        ok, ov = local_reduce(keys[None], values[None])
        return ok[0], ov[0]
    if keys.device.type == "cpu" and values.device.type == "cpu":
        return local_reduce_ref(keys, values)
    if keys.device.type == "meta" and values.device.type == "meta":
        # Shape only (the cost estimator's pass): a copy reads each operand
        # once and writes each result once, as the kernel moves them.
        return keys.clone(), values.clone()
    _build.check_rows("local_reduce", keys, values)
    lib = _build.load()
    n_rows, n_cols = keys.shape
    out_k = torch.full_like(keys, PAD_KEY)
    out_v = torch.zeros_like(values)
    counts = torch.empty(
        n_rows * lib.local_reduce_tiles(n_cols), dtype=torch.int32,
        device=keys.device,
    )
    with torch.cuda.device(keys.device), _build.launch_range("local_reduce"):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.local_reduce_launch(
            keys.data_ptr(), values.data_ptr(), out_k.data_ptr(),
            out_v.data_ptr(), counts.data_ptr(), n_rows, n_cols, stream,
        )
    _build.raise_on_error(lib, "local_reduce", code)
    local_reduce.launches += 1
    return out_k, out_v


local_reduce.launches = 0
