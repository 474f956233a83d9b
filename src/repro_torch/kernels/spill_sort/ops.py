"""Public wrapper of the map's Hopper spill sort (``csrc/spill_sort.cu``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: bits of the kernels' radix digit (``kBits`` in ``csrc/spill_sort.cu``).
DIGIT_BITS = 8


def spill_sort(keys, values, pvalid, addend=None, out=None, passes=None):
    """The map's stable spill sort of (N, C) task rows on the card: keys and
    values int32 and pvalid bool on one CUDA device.  Rows may be column
    slices: each operand's row stride is passed to the kernels.

    Returns (keys, values, pvalid) as ``mapreduce.phases.spill_sort_plain``
    does, slot for slot: each row's live pairs (valid, key not PAD_KEY) in
    ascending key order, ties in slot order, then the row's other slots in
    slot order with their own key, value and valid; every value plus the
    row's entry of ``addend``, an optional (N,) int32 tensor.  ``out``, an
    optional (keys, values, pvalid) triple of (N, C) int32, int32 and bool
    tensors with unit column stride (rows [s, s + N) of the map's
    accumulators), receives the rows and is returned; every slot is
    written.  ``passes``, an optional int32 scalar tensor, gains the number
    of radix digits that vary among each row's live keys, summed over the
    rows.  The kernels run on the current stream; nothing is read back to
    the host.  Raises on what they do not take, CPU and meta tensors
    included.  ``spill_sort.launches`` counts calls.
    """
    _check(keys, values, pvalid, addend, out, passes)
    lib = _build.load()
    N, C = keys.shape
    dev = keys.device
    if out is None:
        out = (torch.empty((N, C), dtype=torch.int32, device=dev),
               torch.empty((N, C), dtype=torch.int32, device=dev),
               torch.empty((N, C), dtype=torch.bool, device=dev))
    scratch = torch.empty(lib.spill_sort_scratch(N, C), dtype=torch.uint8, device=dev)
    ok, ov, op = out
    with torch.cuda.device(dev), _build.launch_range("spill_sort"):
        code = lib.spill_sort_launch(
            keys.data_ptr(), keys.stride(0), values.data_ptr(), values.stride(0),
            pvalid.data_ptr(), pvalid.stride(0), N, C,
            None if addend is None else addend.data_ptr(),
            ok.data_ptr(), ok.stride(0), ov.data_ptr(), ov.stride(0),
            op.data_ptr(), op.stride(0), scratch.data_ptr(),
            None if passes is None else passes.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on_error(lib, "spill_sort", code)
    spill_sort.launches += 1
    return tuple(out)


spill_sort.launches = 0


def _check(keys, values, pvalid, addend, out, passes) -> None:
    """Raise on what the kernels do not take."""
    name = "spill_sort"
    if keys.dtype != torch.int32 or values.dtype != torch.int32 or pvalid.dtype != torch.bool:
        raise TypeError(
            f"{name}: keys and values must be int32 and pvalid bool, got "
            f"{keys.dtype}, {values.dtype} and {pvalid.dtype}")
    if keys.dim() != 2 or not keys.shape == values.shape == pvalid.shape:
        raise ValueError(
            f"{name}: keys, values and pvalid must share one (N, C) shape, got "
            f"{tuple(keys.shape)}, {tuple(values.shape)} and {tuple(pvalid.shape)}")
    N, C = keys.shape
    if not (0 < N <= _build.MAX_ROWS and 0 < C < 2**31):
        raise ValueError(f"{name}: shape {(N, C)} is empty or too large")
    if out is not None:
        if len(out) != 3 or [o.dtype for o in out] != [torch.int32, torch.int32, torch.bool] \
                or any(o.shape != keys.shape for o in out):
            raise ValueError(
                f"{name}: out must be int32, int32 and bool tensors of shape {(N, C)}, got "
                f"{[(tuple(o.shape), o.dtype) for o in out]}")
    rows = (keys, values, pvalid, *(out or ()))
    if C > 1 and any(t.stride(1) != 1 for t in rows):
        raise ValueError(f"{name}: each row must be contiguous (unit column stride)")
    if addend is not None and (addend.dtype != torch.int32 or addend.shape != (N,)
                               or not addend.is_contiguous()):
        raise ValueError(
            f"{name}: addend must be a contiguous ({N},) int32 tensor, got "
            f"{tuple(addend.shape)} {addend.dtype}")
    if passes is not None and (passes.dtype != torch.int32 or passes.numel() != 1):
        raise ValueError(f"{name}: passes must be one int32 element, got "
                         f"{tuple(passes.shape)} {passes.dtype}")
    given = [t for t in (keys, values, pvalid, addend, passes, *(out or ())) if t is not None]
    if keys.device.type != "cuda" or any(t.device != keys.device for t in given):
        raise ValueError(
            f"{name}: every operand must be on one CUDA device, got "
            f"{sorted({str(t.device) for t in given})}")
