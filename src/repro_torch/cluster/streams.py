"""Open-ended arrival streams: the service-mode side of workload.py
(counterpart of ``repro.cluster.streams``).

:func:`~repro_torch.cluster.workload.generate_workload` answers "give me N
jobs"; a live service faces the opposite shape — an unbounded arrival
process whose *rate* varies (daily cycles, bursts, flash crowds) and a
simulator that steps until a horizon rather than draining a fixed trace
(``Cluster.run_service``).  This module supplies the streams:

* arrival **processes** — iterables of strictly increasing arrival times:
  :class:`PoissonProcess` (inhomogeneous, via Lewis–Shedler thinning
  against any ``rate_fn``) and :class:`RenewalProcess` (the open-ended
  extension of ``workload.py``'s poisson/uniform/bursty interarrival
  draws, generated chunk-wise from one rng).  :func:`merge_processes`
  superposes several (e.g. a bursty baseline plus a flash-crowd spike);
* **rate functions** for the Poisson process — :func:`constant_rate`,
  :func:`diurnal_rate` (sinusoidal daily cycle), :func:`flash_crowd_rate`
  (adversarial step overload: rate multiplies by ``factor`` inside each
  crowd window, the provisioning stress case of arXiv:1206.2016);
* :class:`JobStream` — maps a process onto :class:`~repro_torch.cluster.
  workload.JobSpec`\\ s with the same log-uniform sizes / weighted apps /
  optional slack-multiplier deadlines as ``generate_workload``.

Every stream is fully determined by its seed and restartable: iterating
twice (or iterating two identically-configured instances) yields the
identical job sequence — the property that keeps service benchmarks
comparable across policies and PRs, tested in ``tests/test_service.py``.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np

from repro_torch.cluster.workload import (
    APPS,
    ARRIVALS,
    JobSpec,
    _interarrival_gaps,
)

__all__ = [
    "JobStream",
    "PoissonProcess",
    "RenewalProcess",
    "constant_rate",
    "diurnal_rate",
    "flash_crowd_rate",
    "merge_processes",
    "take",
]


# ------------------------------------------------------------ rate functions


def constant_rate(rate: float) -> Callable[[float], float]:
    """λ(t) = rate."""
    if rate < 0:
        raise ValueError(f"rate must be >= 0, got {rate}")
    return lambda t: rate


def diurnal_rate(
    base: float,
    *,
    amplitude: float = 0.5,
    period_s: float = 600.0,
    phase: float = 0.0,
) -> Callable[[float], float]:
    """Sinusoidal day cycle: ``base * (1 + amplitude * sin(...))``.

    ``amplitude`` in [0, 1] keeps the rate non-negative; the peak rate
    (what a thinning sampler must envelope) is ``base * (1 + amplitude)``.
    """
    if base < 0 or not 0.0 <= amplitude <= 1.0:
        raise ValueError(f"bad diurnal rate (base={base}, amp={amplitude})")

    def f(t: float) -> float:
        return base * (
            1.0 + amplitude * math.sin(2.0 * math.pi * t / period_s + phase)
        )

    return f


def flash_crowd_rate(
    base: float | Callable[[float], float],
    crowds: Sequence[tuple[float, float, float]],
) -> Callable[[float], float]:
    """Adversarial step overload: inside each ``(t0, t1, factor)`` window
    the base rate multiplies by ``factor`` — no ramp, the flash crowd
    arrives all at once.  Windows may overlap (factors compose)."""
    base_fn = base if callable(base) else constant_rate(float(base))
    windows = [(float(a), float(b), float(f)) for a, b, f in crowds]
    for a, b, f in windows:
        if b <= a or f < 0:
            raise ValueError(f"bad crowd window ({a}, {b}, {f})")

    def f(t: float) -> float:
        r = base_fn(t)
        for a, b, fac in windows:
            if a <= t < b:
                r *= fac
        return r

    return f


# ---------------------------------------------------------------- processes


class PoissonProcess:
    """Inhomogeneous Poisson arrivals by thinning: candidate events at
    ``peak_rate`` are accepted with probability ``rate_fn(t)/peak_rate``.
    ``rate_fn`` must never exceed ``peak_rate`` (checked per candidate).

    Iterating yields an unbounded, strictly increasing time sequence,
    deterministic in ``seed`` and identical on every fresh iteration.
    """

    def __init__(
        self,
        rate_fn: float | Callable[[float], float],
        *,
        peak_rate: float | None = None,
        seed: int = 0,
        t0: float = 0.0,
    ):
        if callable(rate_fn):
            if peak_rate is None:
                raise ValueError(
                    "a callable rate_fn needs an explicit peak_rate "
                    "envelope for thinning"
                )
            self.rate_fn = rate_fn
        else:
            self.rate_fn = constant_rate(float(rate_fn))
            peak_rate = peak_rate if peak_rate is not None else float(rate_fn)
        if peak_rate <= 0:
            raise ValueError(f"peak_rate must be > 0, got {peak_rate}")
        self.peak_rate = float(peak_rate)
        self.seed = int(seed)
        self.t0 = float(t0)

    def __iter__(self) -> Iterator[float]:
        rng = np.random.default_rng(self.seed)
        t = self.t0
        while True:
            t += float(rng.exponential(1.0 / self.peak_rate))
            lam = self.rate_fn(t)
            if lam > self.peak_rate * (1.0 + 1e-9):
                raise ValueError(
                    f"rate_fn({t:.3f}) = {lam:.4f} exceeds the thinning "
                    f"envelope peak_rate = {self.peak_rate:.4f}"
                )
            if rng.random() * self.peak_rate < lam:
                yield t


class RenewalProcess:
    """Open-ended renewal arrivals reusing ``workload.py``'s interarrival
    draws (poisson / uniform / bursty), generated chunk-wise so the
    sequence extends indefinitely from one seeded rng."""

    def __init__(
        self,
        arrival: str = "bursty",
        *,
        mean_interarrival: float,
        seed: int = 0,
        t0: float = 0.0,
        chunk: int = 256,
    ):
        if arrival not in ARRIVALS:
            raise ValueError(
                f"unknown arrival process {arrival!r}; expected {ARRIVALS}"
            )
        if mean_interarrival <= 0 or chunk < 1:
            raise ValueError("mean_interarrival must be > 0, chunk >= 1")
        self.arrival = arrival
        self.mean_interarrival = float(mean_interarrival)
        self.seed = int(seed)
        self.t0 = float(t0)
        self.chunk = int(chunk)

    def __iter__(self) -> Iterator[float]:
        rng = np.random.default_rng(self.seed)
        t = self.t0
        while True:
            gaps = _interarrival_gaps(
                self.chunk, self.arrival, self.mean_interarrival, rng
            )
            for g in gaps:
                t += float(g)
                yield t


def merge_processes(*processes: Iterable[float]) -> Iterator[float]:
    """Superpose arrival processes into one merged time-ordered stream."""
    return heapq.merge(*processes)


# ---------------------------------------------------------------- job stream


@dataclasses.dataclass
class JobStream:
    """Deterministic open-ended stream of :class:`JobSpec`\\ s.

    ``process`` supplies arrival times (any restartable iterable of
    increasing floats); sizes are log-uniform over ``size_range``, apps
    weighted by ``app_weights``, and — when ``deadline_fraction > 0`` and
    a ``service_estimate`` is given — a ``deadline_fraction`` of jobs
    carry ``arrival + slack * estimate`` deadlines, exactly the
    ``generate_workload`` + ``assign_deadlines`` conventions.  Job ids
    count up from ``start_id``.

    The stream itself never terminates; bound it with :func:`take` or let
    ``Cluster.run_service(until_time=…/until_jobs=…)`` cut it off.
    """

    process: Iterable[float]
    seed: int = 0
    apps: Sequence[str] = APPS
    app_weights: Sequence[float] | None = None
    size_range: tuple[int, int] = (1 << 14, 1 << 18)
    deadline_fraction: float = 0.0
    slack_range: tuple[float, float] = (1.5, 4.0)
    service_estimate: Callable[[JobSpec], float] | None = None
    start_id: int = 0

    def __post_init__(self):
        self.apps = tuple(self.apps)
        for a in self.apps:
            if a not in APPS:
                raise ValueError(f"unknown app {a!r}")
        if self.deadline_fraction > 0 and self.service_estimate is None:
            raise ValueError(
                "deadline_fraction > 0 needs a service_estimate"
            )
        if self.app_weights is not None:
            w = np.asarray(self.app_weights, dtype=np.float64)
            if len(w) != len(self.apps) or w.sum() <= 0:
                raise ValueError(f"bad app_weights {self.app_weights!r}")
            self._p = (w / w.sum()).tolist()
        else:
            self._p = None

    def __iter__(self) -> Iterator[JobSpec]:
        rng = np.random.default_rng(self.seed)
        lo, hi = self.size_range
        log_lo, log_hi = math.log(lo), math.log(hi)
        for job_id, t in enumerate(iter(self.process), start=self.start_id):
            # Fixed four draws per job keeps the sequence aligned (and
            # therefore byte-deterministic) whether or not a particular
            # job ends up with a deadline.
            size = int(math.exp(float(rng.uniform(log_lo, log_hi))))
            app = self.apps[int(rng.choice(len(self.apps), p=self._p))]
            dl_coin = float(rng.random())
            slack = float(rng.uniform(*self.slack_range))
            job = JobSpec(
                job_id=job_id, app=app, size=max(1, size), arrival=float(t)
            )
            if dl_coin < self.deadline_fraction:
                job = dataclasses.replace(
                    job,
                    deadline=job.arrival
                    + slack * float(self.service_estimate(job)),
                )
            yield job


def take(stream: Iterable, n: int) -> list:
    """The first ``n`` items of a stream, materialized."""
    return list(itertools.islice(iter(stream), n))
