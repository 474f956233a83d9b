"""Synthetic corpora for the two benchmark applications.

A copy of ``repro.mapreduce.datagen``: it draws the same
``numpy.random.default_rng`` sequence, so a seed gives the same corpus
byte for byte in both packages.  Zipf-distributed word ids for WordCount,
and fixed-width Exim transaction records with each transaction logging a
burst of 2-6 lines.
"""

from __future__ import annotations

import numpy as np

from repro_torch.mapreduce.apps import RECORD_WIDTH


def wordcount_corpus(
    n_tokens: int, vocab_size: int = 4096, *, zipf_a: float = 1.3, seed: int = 0
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # Zipf over a finite vocab via rejection-free inverse-CDF on ranks.
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks ** (-zipf_a)
    probs /= probs.sum()
    return rng.choice(vocab_size, size=n_tokens, p=probs).astype(np.int32)


def _bursts_loop(rng, n_records: int, n_transactions: int) -> np.ndarray:
    """The reference's loop: one (transaction, burst length) draw pair per
    burst of 2-6 consecutive events of one transaction."""
    txn_ids = []
    while len(txn_ids) < n_records:
        t = int(rng.integers(0, n_transactions))
        burst = int(rng.integers(2, 7))
        txn_ids.extend([t] * burst)
    return np.asarray(txn_ids[:n_records], dtype=np.int32)


def _lemire32(u32: np.ndarray, n: int):
    """numpy's scalar ``integers(0, n)`` for n < 2**32 from one 32-bit draw
    each: Lemire's multiply, and whether the draw would be rejected."""
    m = u32 * np.uint64(n)
    threshold = (2**32 - n) % n
    return m >> np.uint64(32), (m & np.uint64(0xFFFFFFFF)) < threshold


def _bursts(rng, n_records: int, n_transactions: int) -> np.ndarray:
    """:func:`_bursts_loop`'s output and generator state, vectorised.

    A scalar ``integers`` draw below 2**32 takes one 32-bit value, the
    low then the high half of each 64-bit word, so draw pair i is word i:
    the transaction from its low half, the burst length from its high.
    The words come from a copy of the bit generator; the real one then
    skips the words used.  Where a draw would have been rejected (one in
    about 2**32) the loop itself runs instead."""
    if not 2 <= n_transactions < 2**32:
        return _bursts_loop(rng, n_records, n_transactions)
    copy = type(rng.bit_generator)()
    copy.state = rng.bit_generator.state
    if copy.state.get("has_uint32"):
        return _bursts_loop(rng, n_records, n_transactions)
    words = copy.random_raw(n_records // 2 + 1)  # bursts are >= 2 long
    txn, reject_t = _lemire32(words & np.uint64(0xFFFFFFFF), n_transactions)
    burst, reject_b = _lemire32(words >> np.uint64(32), 5)
    burst = burst.astype(np.int64) + 2
    n_bursts = int(np.searchsorted(np.cumsum(burst), n_records)) + 1
    if reject_t[:n_bursts].any() or reject_b[:n_bursts].any():
        return _bursts_loop(rng, n_records, n_transactions)
    rng.bit_generator.random_raw(n_bursts)
    return np.repeat(txn[:n_bursts].astype(np.int32),
                     burst[:n_bursts])[:n_records]


def exim_mainlog(
    n_tokens: int, n_transactions: int = 1024, *, seed: int = 0
) -> np.ndarray:
    """Flat [txn_id, event_type, size]* stream, truncated to n_tokens."""
    rng = np.random.default_rng(seed)
    n_records = n_tokens // RECORD_WIDTH + 1
    # Each transaction produces a burst of 2-6 consecutive events
    # (arrival, delivery attempts, completion) — like a real mainlog.
    txn = _bursts(rng, n_records, n_transactions)
    event = rng.integers(0, 8, size=n_records).astype(np.int32)
    size = rng.integers(200, 4000, size=n_records).astype(np.int32)
    stream = np.stack([txn, event, size], axis=1).reshape(-1)[:n_tokens]
    return stream.astype(np.int32)
