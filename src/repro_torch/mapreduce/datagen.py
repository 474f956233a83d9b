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


def exim_mainlog(
    n_tokens: int, n_transactions: int = 1024, *, seed: int = 0
) -> np.ndarray:
    """Flat [txn_id, event_type, size]* stream, truncated to n_tokens."""
    rng = np.random.default_rng(seed)
    n_records = n_tokens // RECORD_WIDTH + 1
    # Each transaction produces a burst of 2-6 consecutive events
    # (arrival, delivery attempts, completion) — like a real mainlog.
    txn_ids = []
    while len(txn_ids) < n_records:
        t = int(rng.integers(0, n_transactions))
        burst = int(rng.integers(2, 7))
        txn_ids.extend([t] * burst)
    txn = np.asarray(txn_ids[:n_records], dtype=np.int32)
    event = rng.integers(0, 8, size=n_records).astype(np.int32)
    size = rng.integers(200, 4000, size=n_records).astype(np.int32)
    stream = np.stack([txn, event, size], axis=1).reshape(-1)[:n_tokens]
    return stream.astype(np.int32)
