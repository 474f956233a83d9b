"""Public wrapper of the Hopper shuffle merge (``csrc/shuffle_merge.cu``)."""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import _build

_NO_RANGE = contextlib.nullcontext()


def shuffle_merge(keys, values, pvalid, R: int, cap: int, n_rows: int | None = None,
                  stage_range=lambda stage: _NO_RANGE):
    """The lexsort shuffle of (N, C) task rows on the card: keys/values
    int32 and pvalid bool on one CUDA device, each row's valid pairs
    non-decreasing in key (the map's spill sort and the combine leave them
    so; nothing checks it).  Rows may be column slices: each operand's row
    stride is passed to the kernels, so nothing is copied.

    Returns (part_keys, part_vals, dropped) as the plain version
    (``mapreduce.backends.lexsort_partition``) does: (n_rows, cap) int32
    partitions (``n_rows`` >= R, R by default), partition r holding the
    valid pairs whose reducer is r in (key, row, column) order, cut at
    ``cap`` with a (PAD_KEY, 0) tail, and ``dropped`` the int32 count of
    the cut pairs.  The kernels run on the current stream in two stages,
    ``split`` and ``merge``, each inside the context ``stage_range(stage)``
    gives (the engine's spans).  Raises on what the kernels do
    not take, CPU and meta tensors included.  Nothing is read back to the
    host.  ``shuffle_merge.launches`` counts calls.
    """
    n_rows = R if n_rows is None else n_rows
    _check_devices(keys, values, pvalid)
    lib = _build.load()
    _check(lib, keys, values, pvalid, R, cap, n_rows)
    N, C = keys.shape
    dev = keys.device
    part_k = torch.empty((n_rows, cap), dtype=torch.int32, device=dev)
    part_v = torch.empty((n_rows, cap), dtype=torch.int32, device=dev)
    dropped = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.shuffle_merge_scratch(N, C, R), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        args = (keys.data_ptr(), keys.stride(0), values.data_ptr(), values.stride(0),
                pvalid.data_ptr(), pvalid.stride(0), N, C, R, cap, n_rows,
                scratch.data_ptr(), part_k.data_ptr(), part_v.data_ptr(),
                dropped.data_ptr(), torch.cuda.current_stream().cuda_stream)
        for stage, launch in (("split", lib.shuffle_split_launch),
                              ("merge", lib.shuffle_merge_launch)):
            with stage_range(stage), _build.launch_range("shuffle_merge"):
                code = launch(*args)
            _build.raise_on_error(lib, "shuffle_merge", code)
    shuffle_merge.launches += 1
    return part_k, part_v, dropped


shuffle_merge.launches = 0


def _check_devices(keys, values, pvalid) -> None:
    if keys.device.type != "cuda" or {values.device, pvalid.device} != {keys.device}:
        raise ValueError(
            f"shuffle_merge: keys, values and pvalid must be on one CUDA device, got "
            f"{keys.device}, {values.device} and {pvalid.device}"
        )


def _check(lib, keys, values, pvalid, R, cap, n_rows) -> None:
    """Raise on what the kernels do not take."""
    name = "shuffle_merge"
    if keys.dtype != torch.int32 or values.dtype != torch.int32 or pvalid.dtype != torch.bool:
        raise TypeError(
            f"{name}: keys and values must be int32 and pvalid bool, got "
            f"{keys.dtype}, {values.dtype} and {pvalid.dtype}"
        )
    if keys.dim() != 2 or not keys.shape == values.shape == pvalid.shape:
        raise ValueError(
            f"{name}: keys, values and pvalid must share one (N, C) shape, got "
            f"{tuple(keys.shape)}, {tuple(values.shape)} and {tuple(pvalid.shape)}"
        )
    if any(t.stride(1) != 1 for t in (keys, values, pvalid) if t.shape[1] > 1):
        raise ValueError(f"{name}: each row must be contiguous (unit column stride)")
    N, C = keys.shape
    if not (0 < N <= _build.MAX_ROWS and 0 < C and N * C < 2**31):
        raise ValueError(f"{name}: shape {(N, C)} is empty or too large")
    if not 1 <= R <= lib.shuffle_merge_max_reducers() or not R <= n_rows <= _build.MAX_ROWS:
        raise ValueError(f"{name}: R = {R} reducers in {n_rows} partitions is not supported")
    if not 1 <= cap < 2**31:
        raise ValueError(f"{name}: capacity {cap} out of range")
