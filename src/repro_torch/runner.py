"""Profiling harness for the paper's loop on the port's engine.

Counterpart of ``benchmarks/common.py``: the paper runs WordCount and Exim
Mainlog parsing on a Hadoop cluster with 20 (mappers, reducers) settings
in [5, 40], 5 repeats each; here the same two applications run on the
port's engine over a synthetic corpus, the same parameter ranges, each
configuration wall-clocked after one warmup run.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.profiler import timeit
from repro_torch.device import resolve_device
from repro_torch.mapreduce import (
    JobConfig,
    build_job,
    eximparse,
    exim_mainlog,
    wordcount,
    wordcount_corpus,
)

PARAM_RANGE = (5, 40)


def make_app(name: str, tokens: int, seed: int = 0):
    """(app, numpy corpus) for one of the paper's two applications."""
    if name == "wordcount":
        corpus = wordcount_corpus(tokens, vocab_size=4096, seed=seed)
        return wordcount(4096), corpus
    if name == "eximparse":
        corpus = exim_mainlog(tokens, n_transactions=1024, seed=seed)
        return eximparse(1024), corpus
    raise ValueError(name)


class JobRunner:
    """``time(config)`` for one application on one device.

    The corpus is copied to ``device`` once, here, and stays resident, so
    the timed window of a call is the job itself: no host-to-device copy
    inside it.  Jobs are cached per (M, R) and warmed up ``warmup`` times
    before their first timed run.  ``cfg_kwargs`` forwards extra
    ``JobConfig`` fields (e.g. ``reduce_backend="cuda"``), making the
    execution backend one more profiled axis.
    """

    def __init__(self, app, corpus, *, warmup: int = 1, device="cuda",
                 **cfg_kwargs):
        self.device = resolve_device(device)
        self.app = app
        self.corpus = torch.as_tensor(corpus, device=self.device).to(torch.int32)
        self.warmup = warmup
        self.cfg_kwargs = cfg_kwargs
        self._cache: dict[tuple[int, int], object] = {}

    def __call__(self, config) -> float:
        M, R = int(round(config[0])), int(round(config[1]))
        key = (M, R)
        if key not in self._cache:
            job = build_job(
                self.app,
                JobConfig(num_mappers=M, num_reducers=R, **self.cfg_kwargs),
                len(self.corpus),
                device=self.device,
            )
            for _ in range(self.warmup):
                timeit(lambda: job(self.corpus), device=self.device)
            self._cache[key] = job
        job = self._cache[key]
        return timeit(lambda: job(self.corpus), device=self.device)


def training_configs(n: int = 20, seed: int = 0) -> np.ndarray:
    """The paper's 20 profiled settings: spread over [5,40]^2."""
    rng = np.random.default_rng(seed)
    lo, hi = PARAM_RANGE
    # stratified: 16 grid points + 4 random fill-ins
    grid_axis = np.linspace(lo, hi, 4).round()
    pts = [(m, r) for m in grid_axis for r in grid_axis]
    while len(pts) < n:
        pts.append(tuple(rng.integers(lo, hi + 1, 2).tolist()))
    return np.asarray(pts[:n], dtype=np.float64)


def heldout_configs(n: int = 8, seed: int = 123) -> np.ndarray:
    """Random unseen settings for the prediction phase."""
    rng = np.random.default_rng(seed)
    lo, hi = PARAM_RANGE
    return rng.integers(lo, hi + 1, size=(n, 2)).astype(np.float64)
