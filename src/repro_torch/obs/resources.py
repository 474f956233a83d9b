"""Cluster-wide resource timelines folded from per-job phase records
(counterpart of ``repro.obs.resources``).

The telemetry layer measures resources *per job* (``cpu_s`` /
``net_bytes`` counters at the phase fences); the scheduler prices them
*per cluster* (aggregate shuffle demand vs ``net_capacity``, busy CPU vs
the worker pool).  This module is the fold between the two: it places
every completed job's trace phases on the simulation clock (the same
sequential layout the span exporter uses) and accumulates step-function
series of

* **fabric demand** — aggregate nominal shuffle bytes/s on the shared
  wire.  Nominal, not fair-shared: the series shows what the jobs *asked*
  of the fabric, so over-capacity intervals remain visible even though
  the contention-aware ground truth stretched the jobs until the actual
  rate fit under capacity;
* **busy CPU** — aggregate CPU-seconds per second (busy cores) across
  all running phases.

Consumers: Chrome counter tracks under a dedicated "cluster resources"
process (:func:`repro_torch.obs.spans.to_chrome_trace` emits them
automatically when traces carry resource counters), gauges published
into a :class:`repro_torch.obs.metrics.MetricsRegistry` for the Prometheus
exposition, and an over-capacity *episodes* log next to the fabric's own
per-job contention episodes on :class:`repro_torch.cluster.cluster.
TraceResult`.
"""

from __future__ import annotations

import math

__all__ = ["RESOURCE_PID", "ResourceTimeline"]

#: Chrome trace-event process id for the cluster-resource counter tracks
#: (pid 1 = worker slots, 2 = jobs, 3 = slo control).
RESOURCE_PID = 4


def _series(deltas: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Cumulative step function from (t, +/-delta) events.

    Decrements sort first at equal timestamps so back-to-back transfers
    don't spike the level above its true concurrent value.
    """
    out: list[tuple[float, float]] = []
    level = 0.0
    for t, d in sorted(deltas, key=lambda x: (x[0], x[1])):
        level += d
        if out and out[-1][0] == t:
            out[-1] = (t, level)
        else:
            out.append((t, level))
    return out


class ResourceTimeline:
    """Step-function resource series for one completed cluster run."""

    def __init__(
        self,
        net: list[tuple[float, float]],
        cpu: list[tuple[float, float]],
        *,
        net_capacity: float | None = None,
        total_workers: int | None = None,
        t0: float = 0.0,
        t1: float = 0.0,
    ):
        self._net = net            # [(t, bytes_per_s)]
        self._cpu = cpu            # [(t, busy_cpu_seconds_per_s)]
        self.net_capacity = net_capacity
        self.total_workers = total_workers
        self.t0 = float(t0)
        self.t1 = float(t1)

    @classmethod
    def from_result(cls, result) -> "ResourceTimeline":
        """Fold a :class:`~repro_torch.cluster.cluster.TraceResult`'s completed
        jobs into cluster-wide series.  Phases are placed sequentially
        from each job's start (the span layout); negative-wall
        bookkeeping phases carry no resources and are skipped."""
        net_d: list[tuple[float, float]] = []
        cpu_d: list[tuple[float, float]] = []
        lo, hi = math.inf, -math.inf
        for rec in result.records:
            if not rec.completed or rec.trace is None:
                continue
            t = rec.start
            for p in rec.trace.phases:
                if p.wall_s <= 0:
                    continue
                p0, p1 = t, t + p.wall_s
                t = p1
                nb = p.counters.get("net_bytes", 0.0)
                if p.phase == "shuffle" and not nb:
                    nb = p.counters.get("bytes_in", 0.0)
                if nb > 0:
                    rate = nb / p.wall_s
                    net_d += [(p0, rate), (p1, -rate)]
                cpu_s = p.counters.get("cpu_s", 0.0)
                if cpu_s > 0:
                    rate = cpu_s / p.wall_s
                    cpu_d += [(p0, rate), (p1, -rate)]
                lo, hi = min(lo, p0), max(hi, p1)
        if not math.isfinite(lo):
            lo = hi = 0.0
        return cls(
            _series(net_d), _series(cpu_d),
            net_capacity=getattr(result, "net_capacity", None),
            total_workers=getattr(result, "total_workers", None),
            t0=lo, t1=hi,
        )

    # ---- queries --------------------------------------------------------

    @property
    def has_data(self) -> bool:
        return bool(self._net or self._cpu)

    def net_series(self) -> list[tuple[float, float]]:
        """Aggregate nominal fabric demand, [(t, bytes/s)] steps."""
        return list(self._net)

    def cpu_series(self) -> list[tuple[float, float]]:
        """Aggregate busy CPU (CPU-seconds per second), [(t, cores)]."""
        return list(self._cpu)

    @staticmethod
    def _peak(series) -> float:
        return max((v for _, v in series), default=0.0)

    def _mean(self, series) -> float:
        """Time-weighted mean level over [t0, t1]."""
        span = self.t1 - self.t0
        if span <= 0 or not series:
            return 0.0
        area = 0.0
        for (ta, va), (tb, _) in zip(series, series[1:]):
            area += va * (tb - ta)
        # Last step runs to the timeline end (its level is 0 by
        # construction when every transfer closed, so this adds nothing
        # for well-formed series).
        area += series[-1][1] * (self.t1 - series[-1][0])
        return area / span

    def over_capacity_episodes(
        self, capacity: float | None = None
    ) -> list[dict]:
        """Merged intervals where nominal fabric demand exceeds capacity
        (default: the run's ``net_capacity``); [] when unlimited."""
        cap = self.net_capacity if capacity is None else float(capacity)
        if cap is None or not self._net:
            return []
        episodes: list[dict] = []
        open_t: float | None = None
        peak = 0.0
        for i, (t, level) in enumerate(self._net):
            if level > cap:
                if open_t is None:
                    open_t = t
                    peak = level
                else:
                    peak = max(peak, level)
            elif open_t is not None:
                episodes.append({
                    "t0": open_t, "t1": t,
                    "peak_bytes_per_s": peak, "capacity": cap,
                })
                open_t = None
        if open_t is not None:
            episodes.append({
                "t0": open_t, "t1": self.t1,
                "peak_bytes_per_s": peak, "capacity": cap,
            })
        return episodes

    def summary(self) -> dict:
        """Headline utilization numbers (what :meth:`publish` exports)."""
        episodes = self.over_capacity_episodes()
        out = {
            "net_peak_bytes_per_s": self._peak(self._net),
            "net_mean_bytes_per_s": self._mean(self._net),
            "cpu_peak_busy": self._peak(self._cpu),
            "cpu_mean_busy": self._mean(self._cpu),
            "n_over_capacity_episodes": len(episodes),
            "over_capacity_s": sum(e["t1"] - e["t0"] for e in episodes),
        }
        if self.net_capacity:
            out["net_peak_utilization"] = (
                out["net_peak_bytes_per_s"] / self.net_capacity
            )
        if self.total_workers:
            out["cpu_peak_utilization"] = (
                out["cpu_peak_busy"] / self.total_workers
            )
        return out

    # ---- exports --------------------------------------------------------

    def publish(self, registry) -> dict:
        """Set fabric/CPU gauges on a :class:`~repro_torch.obs.metrics.
        MetricsRegistry` (Prometheus exposition); returns the summary."""
        s = self.summary()
        for key in (
            "net_peak_bytes_per_s", "net_mean_bytes_per_s",
            "cpu_peak_busy", "cpu_mean_busy",
            "net_peak_utilization", "cpu_peak_utilization",
        ):
            if key in s:
                registry.gauge(f"fabric_{key}" if key.startswith("net")
                               else f"cluster_{key}").set(float(s[key]))
        registry.counter("fabric_over_capacity_episodes").inc(
            s["n_over_capacity_episodes"]
        )
        return s

    def counter_events(self) -> list[dict]:
        """Chrome "C" counter tracks under the "cluster resources"
        process: fabric demand (+ capacity line) and busy CPU."""
        from repro_torch.obs.spans import _ev

        events = [
            _ev("process_name", "M", 0, RESOURCE_PID, 0,
                args={"name": "cluster resources"}),
        ]
        for t, v in self._net:
            events.append(_ev(
                "fabric_bytes_per_s", "C", t, RESOURCE_PID, 0,
                args={"value": round(v, 6)},
            ))
        if self.net_capacity and self._net:
            for t in (self.t0, self.t1):
                events.append(_ev(
                    "fabric_capacity", "C", t, RESOURCE_PID, 0,
                    args={"value": round(self.net_capacity, 6)},
                ))
        for t, v in self._cpu:
            events.append(_ev(
                "busy_cpu", "C", t, RESOURCE_PID, 0,
                args={"value": round(v, 6)},
            ))
        for i, e in enumerate(self.over_capacity_episodes()):
            events.append(_ev(
                f"fabric over capacity #{i}", "i", e["t0"], RESOURCE_PID,
                0, s="t",
                args={k: round(v, 6) for k, v in e.items()},
            ))
        return events
