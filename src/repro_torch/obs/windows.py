"""Streaming windowed aggregations: sliding P² quantiles, EWMA rates
(counterpart of ``repro.obs.windows``).

The run-lifetime quantiles in :mod:`repro_torch.obs.metrics` answer "how did
this trace do?"; a live service needs "how are the *last W seconds*
doing?" — the quantity SLO burn-rate alarms are defined over.  Three
primitives, all O(1) memory in the stream length and fully deterministic
(same observation sequence → same estimate, the property the bench
regression gate relies on):

* :class:`WindowedQuantile` — a ring of ``n_buckets`` :class:`~repro_torch.obs.
  metrics.P2Quantile` summaries, each owning ``window_s / n_buckets`` of
  sim time.  Old buckets are recycled as time advances; querying merges
  the live buckets deterministically: every bucket contributes weighted
  points (its raw observations while ≤ 5, its five P² markers with
  position-derived weights afterwards) and the estimate is the weighted
  order statistic over the pool.  The error against an exact recompute
  over the same window is bounded by the P² marker approximation per
  bucket — property-tested in ``tests/test_service.py``.
* :class:`EwmaRate` — continuous-time exponentially-weighted event rate
  (events/s with a ``tau_s`` memory), the smooth signal for arrival /
  completion rates.
* :class:`RollingSum` — bucketed sliding sum/count over the window, the
  exact primitive under rolling goodput, windowed queue-depth means, and
  the SLO monitor's good/bad event counts.

Windows are *sim-time* windows: callers pass event timestamps, nothing
here reads a wall clock.
"""

from __future__ import annotations

import math

from repro_torch.obs.metrics import P2Quantile

__all__ = [
    "EwmaRate",
    "RollingSum",
    "WindowedQuantile",
    "p2_weighted_points",
    "weighted_quantile",
]


def p2_weighted_points(est: P2Quantile) -> list[tuple[float, float]]:
    """Deterministic (value, weight) summary of one P² estimator.

    Below six observations the raw (exact) samples are returned with unit
    weight.  Afterwards the five markers stand in for the whole stream:
    marker ``i`` at position ``n[i]`` (1-based) represents the
    observations nearest to it, i.e. weight ``(n[i+1] - n[i-1]) / 2`` for
    interior markers and ``(n[1] - n[0]) / 2 + 0.5`` (symmetrically) for
    the extremes — the midpoint partition of [1, count], so the weights
    sum exactly to the observation count.
    """
    if est.count == 0:
        return []
    if est.count <= 5:
        return [(x, 1.0) for x in est._initial]
    q, n = est._q, est._n
    w = [
        (n[1] - n[0]) / 2.0 + 0.5,
        (n[2] - n[0]) / 2.0,
        (n[3] - n[1]) / 2.0,
        (n[4] - n[2]) / 2.0,
        (n[4] - n[3]) / 2.0 + 0.5,
    ]
    return [(q[i], w[i]) for i in range(5) if w[i] > 0]


def weighted_quantile(
    points: list[tuple[float, float]], p: float
) -> float | None:
    """Order statistic of a weighted point set: the smallest value whose
    cumulative weight reaches ``p`` of the total.  Deterministic and
    monotone in ``p``; ``None`` on an empty/zero-weight set."""
    if not points:
        return None
    pts = sorted(points)
    total = sum(w for _, w in pts)
    if total <= 0:
        return None
    target = p * total
    cum = 0.0
    for v, w in pts:
        cum += w
        if cum >= target:
            return v
    return pts[-1][0]


class _Ring:
    """Shared bucket-ring bookkeeping: map t → bucket index, recycle
    buckets whose epoch left the window."""

    def __init__(self, window_s: float, n_buckets: int):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if n_buckets < 2:
            raise ValueError(f"n_buckets must be >= 2, got {n_buckets}")
        self.window_s = float(window_s)
        self.n_buckets = int(n_buckets)
        self.bucket_s = self.window_s / self.n_buckets
        #: parallel arrays: bucket epoch (t // bucket_s) or None, payload.
        self._epochs: list[int | None] = [None] * self.n_buckets
        self._latest: int | None = None

    def _epoch(self, t: float) -> int:
        return int(math.floor(t / self.bucket_s))

    def slot(self, t: float) -> int:
        """Slot index for an observation at ``t`` (caller resets payload
        when the returned slot's epoch mismatches)."""
        e = self._epoch(t)
        if self._latest is None or e > self._latest:
            self._latest = e
        return e % self.n_buckets

    def live_slots(self, now: float) -> list[int]:
        """Slots whose epoch lies in the window ``(now - W, now]``."""
        e_now = max(
            self._epoch(now),
            self._latest if self._latest is not None else -(2**62),
        )
        lo = e_now - self.n_buckets + 1
        return [
            i for i, e in enumerate(self._epochs)
            if e is not None and lo <= e <= e_now
        ]

    def window_start(self, now: float) -> float:
        """Left edge of the retained window at query time ``now`` — the
        exact span :meth:`live_slots` covers, for recompute tests."""
        e_now = max(
            self._epoch(now),
            self._latest if self._latest is not None else -(2**62),
        )
        return (e_now - self.n_buckets + 1) * self.bucket_s


class WindowedQuantile:
    """Sliding-window quantile: a ring of P² buckets, merged on query."""

    def __init__(self, p: float, window_s: float, n_buckets: int = 8):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile p must be in (0, 1), got {p}")
        self.p = float(p)
        self._ring = _Ring(window_s, n_buckets)
        self._buckets: list[P2Quantile | None] = [None] * n_buckets
        self.count = 0          #: lifetime observations (not windowed)

    @property
    def window_s(self) -> float:
        return self._ring.window_s

    def observe(self, t: float, x: float) -> None:
        slot = self._ring.slot(t)
        e = self._ring._epoch(t)
        if self._ring._epochs[slot] != e:
            self._ring._epochs[slot] = e
            self._buckets[slot] = P2Quantile(self.p)
        self._buckets[slot].add(x)
        self.count += 1

    def window_count(self, now: float) -> int:
        return sum(
            self._buckets[i].count for i in self._ring.live_slots(now)
        )

    def window_start(self, now: float) -> float:
        return self._ring.window_start(now)

    def value(self, now: float) -> float | None:
        """Merged estimate over the live buckets; None if the window is
        empty.  Single-bucket windows return the bucket's own (exact ≤ 5
        observations) P² estimate."""
        live = self._ring.live_slots(now)
        if not live:
            return None
        if len(live) == 1:
            return self._buckets[live[0]].value
        points: list[tuple[float, float]] = []
        for i in live:
            points.extend(p2_weighted_points(self._buckets[i]))
        return weighted_quantile(points, self.p)


class EwmaRate:
    """Continuous-time EWMA event rate (events/s, memory ``tau_s``)."""

    def __init__(self, tau_s: float):
        if tau_s <= 0:
            raise ValueError(f"tau_s must be > 0, got {tau_s}")
        self.tau_s = float(tau_s)
        self._rate = 0.0
        self._t: float | None = None

    def observe(self, t: float, amount: float = 1.0) -> None:
        if self._t is not None and t > self._t:
            self._rate *= math.exp(-(t - self._t) / self.tau_s)
        self._t = t if self._t is None else max(self._t, t)
        self._rate += amount / self.tau_s

    def rate(self, now: float) -> float:
        if self._t is None:
            return 0.0
        if now <= self._t:
            return self._rate
        return self._rate * math.exp(-(now - self._t) / self.tau_s)


class RollingSum:
    """Bucketed sliding sum + count over the last ``window_s`` seconds."""

    def __init__(self, window_s: float, n_buckets: int = 8):
        self._ring = _Ring(window_s, n_buckets)
        self._sums = [0.0] * n_buckets
        self._counts = [0] * n_buckets

    @property
    def window_s(self) -> float:
        return self._ring.window_s

    def observe(self, t: float, amount: float = 1.0) -> None:
        slot = self._ring.slot(t)
        e = self._ring._epoch(t)
        if self._ring._epochs[slot] != e:
            self._ring._epochs[slot] = e
            self._sums[slot] = 0.0
            self._counts[slot] = 0
        self._sums[slot] += float(amount)
        self._counts[slot] += 1

    def total(self, now: float) -> float:
        return sum(self._sums[i] for i in self._ring.live_slots(now))

    def count(self, now: float) -> int:
        return sum(self._counts[i] for i in self._ring.live_slots(now))

    def rate(self, now: float) -> float:
        """Windowed average rate: total / window span."""
        return self.total(now) / self._ring.window_s

    def mean(self, now: float) -> float | None:
        n = self.count(now)
        return self.total(now) / n if n else None

    def window_start(self, now: float) -> float:
        return self._ring.window_start(now)
