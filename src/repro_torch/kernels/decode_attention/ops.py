"""Public wrapper of the Hopper flash-decode kernel (``csrc/decode_attention.cu``)."""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import ATTENTION_DTYPES, check_attention

ROWS, KEYS = 128, 128  # query rows per block, keys per K/V tile (attention_hopper.cuh)
PART_WIDTH = 128  # row width of the float32 partials (kMaxHD)


@functools.cache
def target_blocks(device_index: int) -> int:
    """Blocks to aim for when splitting the keys: one wave, since a bfloat16
    block's 225 KB of shared memory fits one block per SM."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def split_plan(B: int, Sq: int, Hq: int, n_kv: int, S_max: int,
               kv_len: int, target: int) -> tuple[int, int]:
    """(n_splits, keys per split) for the kernel's grid.

    One split while the row tiles alone fill half the card or more
    (prefill); else the visible keys are cut into ``target // row blocks``
    splits of whole 128-key tiles (decode), so that the grid is at most one
    wave of ``target`` blocks.  The float32 tile's 64-key tiles divide them.
    """
    G = Hq // n_kv
    row_blocks = B * n_kv * -(-G * Sq // ROWS)
    key_tiles = max(1, -(-min(S_max, kv_len) // KEYS))
    n_splits = max(1, min(key_tiles, target // row_blocks))
    tiles_per_split = -(-key_tiles // n_splits)
    n_splits = -(-key_tiles // tiles_per_split)  # no empty split
    return n_splits, tiles_per_split * KEYS


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     kv_len: int) -> torch.Tensor:
    """q (B, Sq, Hq, hd); caches (B, S_max, n_kv, hd); ``kv_len`` a host int.

    Returns (B, Sq, Hq, hd): query qi at position kv_len - Sq + qi attends
    to the cache slots up to it.  CPU tensors take the plain version; CUDA
    tensors (float32 or bfloat16, contiguous, hd a multiple of 16 up to 128)
    launch the kernel on the current stream, or raise.
    ``decode_attention.launches`` counts calls that launched the kernel
    (with its combine pass, when the keys were split).
    """
    if (q.device.type == "cpu" and k_cache.device.type == "cpu"
            and v_cache.device.type == "cpu"):
        return decode_attention_ref(q, k_cache, v_cache, kv_len)
    check_attention("decode_attention", q, k_cache, v_cache)
    kv_len = int(kv_len)
    if not 0 < kv_len < 2**31 - q.shape[1]:
        raise ValueError(f"decode_attention: kv_len {kv_len} out of range")
    lib = _build.load()
    B, Sq, Hq, hd = q.shape
    S_max, n_kv = k_cache.shape[1], k_cache.shape[2]
    n_splits, split_keys = split_plan(B, Sq, Hq, n_kv, S_max, kv_len,
                                      target_blocks(q.device.index))
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if n_splits > 1:
        rows = n_splits * B * Hq * Sq
        part_acc = torch.empty((rows, PART_WIDTH), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((rows, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            part_acc.data_ptr() if part_acc is not None else None,
            part_ml.data_ptr() if part_ml is not None else None,
            ATTENTION_DTYPES[q.dtype], B, Sq, S_max, Hq, n_kv, hd, kv_len,
            n_splits, split_keys, hd**-0.5, stream,
        )
    _build.raise_on_error(lib, "decode_attention", code)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
