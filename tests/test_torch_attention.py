"""The port's attention kernels' plain versions against the reference's
Pallas kernels (interpret mode) and pure-jnp oracles, on the CPU.

Inputs come from a seeded numpy generator and go to both packages.
Tolerances are the reference tests' own (``tests/test_kernels.py``):
2e-5 in float32, 5e-2 in bfloat16.  The port keeps ``p`` in float32 into
P.V like the Pallas kernels, while the oracles round it to the input
dtype; in bfloat16 the oracles differ from both by up to that 5e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.decode_attention import decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_ref,
    split_plan,
)
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _inputs(seed, *shapes, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":  # round once so both packages see the same values
        arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrays]
    jx = [jnp.asarray(a, dtype) for a in arrays]
    th = [torch.from_numpy(np.array(a)).to(getattr(torch, dtype)) for a in arrays]
    return jx, th


def _close(got, *wants, tol):
    got = got.float().numpy()
    for want in wants:
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True),
    (1, 256, 256, 8, 8, 128, True),
    (2, 100, 100, 4, 1, 32, True),     # ragged sequence
    (1, 64, 192, 2, 2, 80, False),     # Sk > Sq, odd head_dim
    (1, 128, 128, 16, 2, 128, True),   # deep GQA grouping
]


@pytest.mark.parametrize("B,Sq,Sk,Hq,nkv,hd,causal", FLASH_CASES)
def test_flash_plain_matches_pallas_and_oracle(B, Sq, Sk, Hq, nkv, hd, causal):
    (q, k, v), (tq, tk, tv) = _inputs(Sq * Hq + hd, (B, Sq, Hq, hd), (B, Sk, nkv, hd),
                                      (B, Sk, nkv, hd))
    got = flash_attention(tq, tk, tv, causal=causal)  # CPU tensors: the plain version
    _close(got, jax_flash(q, k, v, causal=causal),
           jax_attention_ref(q, k, v, causal=causal), tol=TOL["float32"])


def test_flash_plain_bfloat16():
    (q, k, v), (tq, tk, tv) = _inputs(7, (1, 128, 4, 64), (1, 128, 2, 64), (1, 128, 2, 64),
                                      dtype="bfloat16")
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    _close(got, jax_flash(q, k, v, causal=True), jax_attention_ref(q, k, v, causal=True),
           tol=TOL["bfloat16"])


DECODE_CASES = [
    (2, 1, 256, 4, 2, 64, 100),
    (1, 1, 1024, 8, 8, 128, 1024),
    (2, 4, 512, 4, 1, 32, 300),
    (1, 1, 96, 2, 2, 80, 7),
    (2, 8, 256, 4, 2, 32, 8),      # prefill-shaped: the whole prompt at once
    (1, 8, 256, 4, 2, 64, 40),     # 8 new rows appended after 32
    (1, 4, 128, 4, 2, 32, 140),    # kv_len > S_max: every slot visible
]


@pytest.mark.parametrize("B,Sq,S_max,Hq,nkv,hd,kv_len", DECODE_CASES)
def test_decode_plain_matches_pallas_and_oracle(B, Sq, S_max, Hq, nkv, hd, kv_len):
    (q, k, v), (tq, tk, tv) = _inputs(S_max + kv_len, (B, Sq, Hq, hd), (B, S_max, nkv, hd),
                                      (B, S_max, nkv, hd))
    got = decode_attention(tq, tk, tv, kv_len)
    _close(got, jax_decode(q, k, v, kv_len, block_k=128), jax_decode_ref(q, k, v, kv_len),
           tol=TOL["float32"])


def test_decode_plain_bfloat16():
    (q, k, v), (tq, tk, tv) = _inputs(11, (2, 1, 4, 64), (2, 256, 2, 64), (2, 256, 2, 64),
                                      dtype="bfloat16")
    got = decode_attention(tq, tk, tv, 100)
    _close(got, jax_decode(q, k, v, 100, block_k=128), jax_decode_ref(q, k, v, 100),
           tol=TOL["bfloat16"])


def test_decode_plain_ignores_garbage_beyond_kv_len():
    _, (q, k, v) = _inputs(3, (1, 1, 2, 32), (1, 128, 2, 32), (1, 128, 2, 32))
    out1 = decode_attention(q, k, v, 50)
    k2, v2 = k.clone(), v.clone()
    k2[:, 50:] = 1e4
    v2[:, 50:] = -1e4
    np.testing.assert_allclose(decode_attention(q, k2, v2, 50).numpy(), out1.numpy(),
                               rtol=1e-6)


def test_plain_versions_agree_where_they_overlap():
    """Decode over a full cache at kv_len = Sq is causal flash attention."""
    _, (q, k, v) = _inputs(5, (2, 48, 4, 32), (2, 48, 2, 32), (2, 48, 2, 32))
    np.testing.assert_allclose(decode_attention_ref(q, k, v, 48).numpy(),
                               flash_attention_ref(q, k, v, causal=True).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_masked_row_gives_zero_not_nan():
    """A query with no visible key (kv_len < Sq) comes out 0."""
    _, (q, k, v) = _inputs(9, (1, 4, 2, 16), (1, 16, 2, 16), (1, 16, 2, 16))
    out = decode_attention(q, k, v, 2)
    assert torch.isfinite(out).all()
    assert torch.equal(out[:, :2], torch.zeros_like(out[:, :2]))


@pytest.mark.parametrize("B,Sq,Hq,nkv,S_max,kv_len,want", [
    (8, 1, 16, 8, 32768, 32768, (2, 128 * 128)),  # decode: split the cache
    (1, 1, 16, 8, 32768, 32768, (16, 16 * 128)),  # decode at batch 1: more splits
    (8, 2048, 16, 8, 4096, 2048, (1, 16 * 128)),  # prefill: rows fill the card
    (1, 1, 16, 8, 256, 9, (1, 128)),              # one tile
    (1, 1, 16, 8, 10, 12, (1, 128)),              # kv_len past S_max
])
def test_split_plan(B, Sq, Hq, nkv, S_max, kv_len, want):
    n_splits, split_keys = split_plan(B, Sq, Hq, nkv, S_max, kv_len, 132)
    assert (n_splits, split_keys) == want
    assert split_keys % 128 == 0 and (n_splits - 1) * split_keys < min(S_max, kv_len)


@pytest.mark.parametrize("B,Sq,Hq,nkv,S_max,kv_len", [
    (8, 1, 16, 8, 32768, 32768),    # decode serving shape: G * Sq = 2 rows
    (8, 2048, 16, 8, 4096, 2048),   # prefill serving shape
    (1, 8192, 16, 8, 8192, 8192),   # the flash shape as a full cache
    (2, 1, 16, 8, 8192, 6000),      # the card tests' edge shapes
    (1, 200, 16, 8, 512, 300),
    (2, 40, 16, 4, 255, 129),       # 128-row tiles across query heads, ragged S
    (3, 1, 4, 2, 96, 7),
    (1, 4, 4, 2, 128, 140),         # kv_len past S_max
])
@pytest.mark.parametrize("target", [132, 4 * 132])
def test_split_plan_tiles_the_visible_keys(B, Sq, Hq, nkv, S_max, kv_len, target):
    """Every split is a whole number of 128-key tiles, none is empty, the
    splits cover the visible keys, and every tile of every split holds a
    key that some row of its block sees (decode: the last query sees every
    visible key, so each split's first key must be one), and the grid is
    at most one wave of ``target`` blocks."""
    key_end = min(S_max, kv_len)
    n_splits, split_keys = split_plan(B, Sq, Hq, nkv, S_max, kv_len, target)
    assert n_splits >= 1 and split_keys % 128 == 0
    assert (n_splits - 1) * split_keys < key_end <= n_splits * split_keys
    last_query = kv_len - 1  # the position the block's last row sits at
    for split in range(n_splits):
        tiles = range(split * split_keys, min((split + 1) * split_keys, key_end), 128)
        assert tiles and all(t <= min(last_query, key_end - 1) for t in tiles)
    row_tiles = B * nkv * -(-(Hq // nkv) * Sq // 128)
    assert row_tiles * n_splits <= max(target, row_tiles)  # at most one wave
    if 2 * row_tiles > target:
        assert n_splits == 1  # the rows alone fill half the card or more
    elif key_end > 128:
        assert n_splits > 1  # decode at G * Sq = 2: the keys are split
