"""Deterministic, resumable, per-host synthetic token pipeline
(counterpart of ``repro.data.pipeline``).

* **determinism / resumability**: a batch is a pure function of (seed,
  step, host id), so restoring a checkpoint at step k resumes the exact
  stream with no replay of the k steps before it;
* **per-host slices**: each data-parallel host draws only its slice of the
  global batch;
* **straggler isolation**: nothing is carried between steps, so re-running a
  failed host's slice gives the same tokens.

The corpus follows the reference's rule: uniform tokens, and at each odd
position, with probability ``structure``, ``(previous even token * 7 + 1)
% vocab`` instead, so a next-token model can learn it.  The draws come
from numpy's generator keyed by (seed, step, host id), not from JAX's
threefry stream: the same distributions as the reference's batches, not
the same numbers (the convention ``Transformer(generator=...)`` follows
for weights).  The parity tests feed the reference's batches to both
packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # structure of the synthetic language (mixture weight of copy-prev rule)
    structure: float = 0.7


def structured_tokens(base: np.ndarray, gate: np.ndarray, vocab_size: int) -> np.ndarray:
    """The reference's rule: odd positions where ``gate`` is set become
    ``(token before them * 7 + 1) % vocab_size``; the rest keep ``base``
    (position 0's predecessor wraps to the row's last token, as
    ``jnp.roll`` does)."""
    prev_even = np.roll(base, 1, axis=1).astype(np.int64)
    structured = (prev_even * 7 + 1) % vocab_size
    odd = (np.arange(base.shape[1]) % 2 == 1)[None, :]
    return np.where(odd & gate, structured, base).astype(np.int32)


class TokenPipeline:
    """Stateless per step; the pipeline's state is the step counter."""

    def __init__(self, cfg: DataConfig, *, host_id: int = 0, n_hosts: int = 1,
                 device="cuda"):
        if cfg.global_batch % n_hosts:
            raise ValueError(
                f"global_batch {cfg.global_batch} not divisible by {n_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> dict:
        """This host's slice of global step ``step``'s batch: {"tokens":
        (local_batch, seq_len) int32} on the pipeline's device."""
        cfg = self.cfg
        rng = np.random.default_rng([cfg.seed, step, self.host_id])
        shape = (self.local_batch, cfg.seq_len)
        base = rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)
        gate = rng.random(shape) < cfg.structure
        tokens = structured_tokens(base, gate, cfg.vocab_size)
        return {"tokens": torch.from_numpy(tokens).to(self.device)}

    def state_dict(self, step: int) -> dict:
        return {"step": int(step), "seed": self.cfg.seed}

    @staticmethod
    def resume_step(state: dict) -> int:
        return int(state["step"])


def host_batches(pipeline: TokenPipeline, start_step: int = 0):
    """Infinite iterator of (step, batch)."""
    step = start_step
    while True:
        yield step, pipeline.batch_at(step)
        step += 1


__all__ = ["DataConfig", "TokenPipeline", "host_batches", "structured_tokens"]
