"""Workload generation for the cluster scheduling layer
(counterpart of ``repro.cluster.workload``).

A workload is a *trace*: a time-ordered stream of heterogeneous MapReduce
jobs (the paper's two applications at varying input sizes), each with an
arrival time drawn from a configurable arrival process and, optionally, a
completion deadline (SLO).  Traces are fully determined by their seed so
every policy in a benchmark sees the identical job stream — the multi-job
analogue of the paper's "same experiment set for every model" discipline.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

#: applications the workload generator knows how to emit (the paper's two).
APPS = ("wordcount", "eximparse")

ARRIVALS = ("poisson", "uniform", "bursty")


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One job in a trace (immutable; scheduling state lives in JobRecord)."""

    job_id: int
    app: str                 # "wordcount" | "eximparse"
    size: int                # input size in tokens
    arrival: float           # seconds since trace start
    deadline: float | None = None  # absolute completion deadline, or None

    def __post_init__(self):
        if self.app not in APPS:
            raise ValueError(f"unknown app {self.app!r}; expected {APPS}")
        if self.size < 1 or self.arrival < 0:
            raise ValueError(f"bad job spec {self}")


def _interarrival_gaps(
    n: int, arrival: str, mean_gap: float, rng: np.random.Generator
) -> np.ndarray:
    if arrival == "poisson":
        return rng.exponential(mean_gap, size=n)
    if arrival == "uniform":
        return rng.uniform(0.0, 2.0 * mean_gap, size=n)
    if arrival == "bursty":
        # Bursts of back-to-back arrivals separated by long idle gaps:
        # same mean rate as "poisson", much higher variance — the stress
        # case for admission control.
        in_burst = rng.random(n) < 0.75
        long_gap = rng.exponential(4.0 * mean_gap, size=n)
        short_gap = rng.exponential(mean_gap / 12.0, size=n)
        return np.where(in_burst, short_gap, long_gap)
    raise ValueError(f"unknown arrival process {arrival!r}; expected {ARRIVALS}")


def generate_workload(
    n_jobs: int,
    *,
    seed: int = 0,
    arrival: str = "poisson",
    mean_interarrival: float = 0.5,
    apps: Sequence[str] = APPS,
    app_weights: Sequence[float] | None = None,
    size_range: tuple[int, int] = (1 << 14, 1 << 18),
    first_arrival: float = 0.0,
) -> list[JobSpec]:
    """Generate a deterministic heterogeneous trace of ``n_jobs`` jobs.

    Sizes are log-uniform over ``size_range`` (small jobs are common, big
    jobs dominate total work — the canonical heavy-tailed cluster mix);
    applications are drawn with ``app_weights`` (uniform by default).
    Deadlines are assigned separately by :func:`assign_deadlines` because a
    sensible deadline needs a service-time estimate, which is the
    scheduler's (oracle/model's) business, not the trace's.
    """
    if n_jobs < 1:
        raise ValueError("n_jobs must be >= 1")
    for a in apps:
        if a not in APPS:
            raise ValueError(f"unknown app {a!r}")
    rng = np.random.default_rng(seed)
    gaps = _interarrival_gaps(n_jobs, arrival, mean_interarrival, rng)
    gaps[0] = first_arrival
    arrivals = np.cumsum(gaps)
    lo, hi = size_range
    sizes = np.exp(
        rng.uniform(math.log(lo), math.log(hi), size=n_jobs)
    ).astype(np.int64)
    p = None
    if app_weights is not None:
        w = np.asarray(app_weights, dtype=np.float64)
        p = w / w.sum()
    chosen = rng.choice(len(apps), size=n_jobs, p=p)
    return [
        JobSpec(
            job_id=i,
            app=apps[int(chosen[i])],
            size=int(sizes[i]),
            arrival=float(arrivals[i]),
        )
        for i in range(n_jobs)
    ]


def assign_deadlines(
    jobs: Sequence[JobSpec],
    service_estimate: Callable[[JobSpec], float],
    *,
    slack_range: tuple[float, float] = (1.5, 4.0),
    fraction: float = 1.0,
    seed: int = 0,
) -> list[JobSpec]:
    """Attach deadlines: ``arrival + slack * service_estimate(job)``.

    ``service_estimate`` is typically the runtime oracle (or a fitted model)
    evaluated at a nominal configuration; ``slack_range`` draws a per-job
    multiplier, so some jobs are comfortably feasible and some are tight —
    the spread an admission-control policy has to discriminate.  Only a
    ``fraction`` of jobs get deadlines (the rest are best-effort, deadline
    ``None``).
    """
    rng = np.random.default_rng(seed)
    out = []
    for job in jobs:
        if rng.random() <= fraction:
            slack = rng.uniform(*slack_range)
            deadline = job.arrival + slack * float(service_estimate(job))
            out.append(dataclasses.replace(job, deadline=deadline))
        else:
            out.append(job)
    return out
