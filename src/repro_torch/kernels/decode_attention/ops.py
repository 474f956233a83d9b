"""Public wrapper of the Hopper flash-decode kernel (``csrc/decode_attention.cu``)."""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import (
    ATTENTION_DTYPES,
    MAX_HEAD_DIM,
    check_attention,
)

ROWS = 128  # query rows per block (attention_hopper.cuh)
PART_WIDTH = MAX_HEAD_DIM  # row width of the float32 partials (kMaxHD)


def tile_keys(hd: int) -> int:
    """Keys per K/V tile of the bfloat16 instance that runs head_dim ``hd``
    (``Layout<HD>::kKeys``): 128, or 64 past head_dim 128, where two slots
    of 128 keys would not fit a block's shared memory.  The float32 tile's
    keys (64, or 32) divide it."""
    return 64 if hd > 128 else 128


@functools.cache
def target_blocks(device_index: int) -> int:
    """Blocks to aim for when splitting the keys: one wave, since a bfloat16
    block's 145-225 KB of shared memory fits one block per SM."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def split_plan(B: int, Sq: int, Hq: int, n_kv: int, S_max: int,
               kv_len: int, target: int, hd: int) -> tuple[int, int]:
    """(n_splits, keys per split) for the kernel's grid at head_dim ``hd``.

    One split while the row tiles alone fill half the card or more
    (prefill); else the visible keys are cut into ``target // row blocks``
    splits of whole key tiles (``tile_keys(hd)``) (decode), so that the
    grid is at most one wave of ``target`` blocks.  The float32 tile's key
    tiles divide them.
    """
    G = Hq // n_kv
    keys = tile_keys(hd)
    row_blocks = B * n_kv * -(-G * Sq // ROWS)
    key_tiles = max(1, -(-min(S_max, kv_len) // keys))
    n_splits = max(1, min(key_tiles, target // row_blocks))
    tiles_per_split = -(-key_tiles // n_splits)
    n_splits = -(-key_tiles // tiles_per_split)  # no empty split
    return n_splits, tiles_per_split * keys


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     kv_len: int) -> torch.Tensor:
    """q (B, Sq, Hq, hd); caches (B, S_max, n_kv, hd); ``kv_len`` a host int.

    Returns (B, Sq, Hq, hd): query qi at position kv_len - Sq + qi attends
    to the cache slots up to it.  CPU tensors take the plain version; CUDA
    tensors (float32 or bfloat16, contiguous, hd a multiple of 16 up to 256)
    launch the kernel on the current stream, or raise, also under autograd
    with an operand that requires grad (the kernel has no backward).
    ``decode_attention.launches`` counts calls that launched the kernel
    (with its combine pass, when the keys were split).
    """
    if (q.device.type == "cpu" and k_cache.device.type == "cpu"
            and v_cache.device.type == "cpu"):
        return decode_attention_ref(q, k_cache, v_cache, kv_len)
    check_attention("decode_attention", q, k_cache, v_cache)
    _build.refuse_autograd("decode_attention", "use_flash=False: models.attention._sdpa",
                           q, k_cache, v_cache)
    kv_len = int(kv_len)
    if not 0 < kv_len < 2**31 - q.shape[1]:
        raise ValueError(f"decode_attention: kv_len {kv_len} out of range")
    lib = _build.load()
    B, Sq, Hq, hd = q.shape
    S_max, n_kv = k_cache.shape[1], k_cache.shape[2]
    n_splits, split_keys = split_plan(B, Sq, Hq, n_kv, S_max, kv_len,
                                      target_blocks(q.device.index), hd)
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if n_splits > 1:
        rows = n_splits * B * Hq * Sq
        part_acc = torch.empty((rows, PART_WIDTH), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((rows, 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device), _build.launch_range("decode_attention"):
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
