"""Profiling phase (paper Fig. 2a); counterpart of ``repro.core.profiler``.

``profile_experiments`` runs an application callable under each
configuration, ``repeats`` times each (paper: 5), and keeps the mean
total execution time.  The profiler only sees ``fn(config) -> seconds``:
the paper's black-box treatment of MapReduce jobs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class ProfileResult:
    """Profiling-phase output: the training set for the modeling phase."""

    params: np.ndarray  # (M, N) configuration values
    times: np.ndarray   # (M,)  mean execution time per experiment (seconds)
    raw_times: np.ndarray  # (M, repeats) all repeats, for variance analysis
    param_names: tuple[str, ...]

    @property
    def n_experiments(self) -> int:
        return self.params.shape[0]

    def repeat_cv(self) -> np.ndarray:
        """Coefficient of variation across repeats, per experiment."""
        mean = self.raw_times.mean(axis=1)
        std = self.raw_times.std(axis=1)
        return std / np.maximum(mean, 1e-12)


def timeit(fn: Callable[[], object], device="cuda") -> float:
    """Wall-clock one call of ``fn``.  On a CUDA device the window is fenced
    by ``torch.cuda.synchronize`` on both sides, so it holds exactly the
    work ``fn`` queued; CPU work is synchronous and needs no fence."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def profile_experiments(
    run_fn: Callable[[Sequence[float]], float],
    configs: np.ndarray,
    *,
    repeats: int = 5,
    param_names: Sequence[str] | None = None,
    warmup: int = 0,
    reducer: str = "mean",
    verbose: bool = False,
) -> ProfileResult:
    """Run every config ``repeats`` times; aggregate per paper Fig. 2a.

    run_fn(config_row) returns the total execution time in seconds of one
    run under that configuration.  ``reducer``: "mean" is paper-faithful;
    "median"/"min" are noise-robust options.
    """
    configs = np.asarray(configs, dtype=np.float64)
    if configs.ndim != 2:
        raise ValueError(f"configs must be (M, N), got {configs.shape}")
    M, N = configs.shape
    names = tuple(param_names or (f"p{i}" for i in range(N)))
    raw = np.zeros((M, repeats), dtype=np.float64)
    for i, row in enumerate(configs):
        for _ in range(warmup):
            run_fn(row)
        for r in range(repeats):
            raw[i, r] = float(run_fn(row))
        if verbose:
            print(
                f"[profiler] config {i + 1}/{M} "
                f"{dict(zip(names, row))}: "
                f"mean={raw[i].mean():.4f}s cv={raw[i].std() / max(raw[i].mean(), 1e-12):.3f}"
            )
    if reducer == "mean":
        times = raw.mean(axis=1)
    elif reducer == "median":
        times = np.median(raw, axis=1)
    elif reducer == "min":
        times = raw.min(axis=1)
    else:
        raise ValueError(f"unknown reducer {reducer!r}")
    return ProfileResult(
        params=configs, times=times, raw_times=raw, param_names=names
    )


def profile_categorical(
    run_fns: Mapping[str, Callable[[Sequence[float]], float]],
    configs: np.ndarray,
    *,
    repeats: int = 5,
    param_names: Sequence[str] | None = None,
    warmup: int = 0,
    reducer: str = "mean",
    verbose: bool = False,
) -> dict[str, ProfileResult]:
    """Profile the same configuration set under each categorical variant
    (e.g. the engine's reduce backend: "torch" / "scatter_reduce" / "cuda")."""
    return {
        cat: profile_experiments(
            fn,
            configs,
            repeats=repeats,
            param_names=param_names,
            warmup=warmup,
            reducer=reducer,
            verbose=verbose,
        )
        for cat, fn in run_fns.items()
    }
