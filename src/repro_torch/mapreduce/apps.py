"""The paper's two benchmark applications (counterpart of ``repro.mapreduce.apps``).

* **WordCount** — each map task emits ``<word, 1>``; reducers sum per word.
* **Exim Mainlog parsing** — fixed-width ``[txn_id, event_type, size]``
  records; map emits ``<txn_id, size>`` and reducers sum per transaction.

Map functions take a (W, S) batch of tasks and return (W, P) pairs.
"""

from __future__ import annotations

import torch

from repro_torch.mapreduce.engine import MapReduceApp, PAD_KEY


def _wordcount_map(tokens, valid):
    """<line of words> -> <word, 1> pairs."""
    keys = torch.where(valid, tokens, PAD_KEY)
    values = valid.to(torch.int32)
    return keys, values, valid


def wordcount(vocab_size: int = 4096) -> MapReduceApp:
    return MapReduceApp(
        name="wordcount",
        key_space=vocab_size,
        map_fn=_wordcount_map,
        pairs_per_token=1,
        reduce_op="sum",
    )


RECORD_WIDTH = 3  # [txn_id, event_type, size_bytes]


def _eximparse_map(tokens, valid):
    """Parse fixed-width records from each split; emit <txn_id, size>.

    A split of S tokens holds S // RECORD_WIDTH whole records; a trailing
    partial record is invalid.  Output is padded to S pairs per task.
    """
    W, S = tokens.shape
    n_rec = S // RECORD_WIDTH
    rec = tokens[:, : n_rec * RECORD_WIDTH].reshape(W, n_rec, RECORD_WIDTH)
    rec_valid = valid[:, : n_rec * RECORD_WIDTH].reshape(
        W, n_rec, RECORD_WIDTH
    ).all(dim=2)
    keys = torch.where(rec_valid, rec[:, :, 0], PAD_KEY)
    values = torch.where(rec_valid, rec[:, :, 2], 0).to(torch.int32)
    pad = S - n_rec
    dev = tokens.device
    keys = torch.cat(
        [keys, torch.full((W, pad), PAD_KEY, dtype=torch.int32, device=dev)],
        dim=1,
    )
    values = torch.cat(
        [values, torch.zeros((W, pad), dtype=torch.int32, device=dev)], dim=1
    )
    pvalid = torch.cat(
        [rec_valid, torch.zeros((W, pad), dtype=torch.bool, device=dev)], dim=1
    )
    return keys, values, pvalid


def eximparse(n_transactions: int = 1024) -> MapReduceApp:
    return MapReduceApp(
        name="eximparse",
        key_space=n_transactions,
        map_fn=_eximparse_map,
        pairs_per_token=1,
        reduce_op="sum",
    )
