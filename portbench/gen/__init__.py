"""Corpora made on the device from a seed, in a few large calls.

WordCount draws word ids from a Zipf law over a finite vocabulary, the
configuration's exponent and size.  An Exim mainlog is a flat stream of
``[message_id, event_type, size]`` records in which each message logs a
burst of consecutive lines under an id of its own; ids rise with arrival,
as Exim's, which encode the time, do.  The draws come from a
``torch.Generator`` on the device, so one seed gives one corpus on every
card of one kind, and nothing is made on the host.
"""

from __future__ import annotations

import torch

RECORD_WIDTH = 3  # [message_id, event_type, size]
#: uniforms drawn per call: bounds the float64 scratch of the Zipf draw
CHUNK = 1 << 26


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def zipf_probs(vocab: int, a: float, device) -> torch.Tensor:
    """P(word id i) proportional to (i + 1) ** -a, as float64."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    p = ranks ** (-a)
    return p / p.sum()


def wordcount(n: int, vocab: int, zipf_a: float, g: torch.Generator,
              device) -> torch.Tensor:
    """(n,) int32 word ids by the inverse CDF of the Zipf law."""
    cdf = torch.cumsum(zipf_probs(vocab, zipf_a, device), 0)
    out = torch.empty(n, dtype=torch.int32, device=device)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        u = torch.rand(hi - lo, dtype=torch.float64, generator=g, device=device)
        ids = torch.searchsorted(cdf, u, right=True).clamp_(max=vocab - 1)
        out[lo:hi] = ids
    return out


def exim_records(n_tokens: int) -> int:
    """Records drawn for an ``n_tokens`` stream (the last one cut)."""
    return n_tokens // RECORD_WIDTH + 1


def exim_key_space(n_tokens: int, data: dict) -> int:
    """An upper bound on the message ids of an ``n_tokens`` stream."""
    return exim_records(n_tokens) // data["burst"][0] + 1


def exim_fields(n_records: int, data: dict, g: torch.Generator, device):
    """The record fields and the burst lengths they were cut from:
    (message id, event, size, bursts), each int32.  ``data`` gives the
    burst lengths, the event types and the sizes, each range with both
    ends included."""
    lo, hi = data["burst"]
    n_bursts = n_records // lo + 1
    bursts = torch.randint(lo, hi + 1, (n_bursts,), generator=g, device=device,
                           dtype=torch.int32)
    used = int(torch.searchsorted(torch.cumsum(bursts, 0, dtype=torch.int64),
                                  n_records)) + 1
    bursts = bursts[:used]
    ids = torch.arange(used, device=device, dtype=torch.int32)
    lines = torch.repeat_interleave(ids, bursts)[:n_records]
    event = torch.randint(0, data["events"], (n_records,), generator=g,
                          device=device, dtype=torch.int32)
    size = torch.randint(data["size"][0], data["size"][1] + 1, (n_records,),
                         generator=g, device=device, dtype=torch.int32)
    return lines, event, size, bursts


def exim(n: int, data: dict, g: torch.Generator, device) -> torch.Tensor:
    """(n,) int32 flat record stream, cut at n tokens."""
    ids, event, size, _ = exim_fields(exim_records(n), data, g, device)
    return torch.stack([ids, event, size], dim=1).reshape(-1)[:n].contiguous()


def corpus(config: dict, seed: int, device, n: int | None = None) -> torch.Tensor:
    """The corpus a configuration names, ``n`` tokens (default its own)."""
    n = int(config["tokens"] if n is None else n)
    g = generator(seed, device)
    data = config["data"]
    if config["app"] == "wordcount":
        return wordcount(n, data["vocab"], data["zipf_a"], g, device)
    if config["app"] == "exim":
        return exim(n, data, g, device)
    raise ValueError(f"unknown app {config['app']!r}")


def key_space(config: dict, n: int | None = None) -> int:
    """The keys a configuration's corpus of ``n`` tokens can hold: the
    vocabulary, or the message ids."""
    n = int(config["tokens"] if n is None else n)
    if config["app"] == "wordcount":
        return int(config["data"]["vocab"])
    return exim_key_space(n, config["data"])
