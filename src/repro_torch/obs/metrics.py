"""Streaming service metrics: counters, gauges, P² quantile histograms
(counterpart of ``repro.obs.metrics``).

The ROADMAP's continuous-service item needs p50/p99 turnaround and goodput
under overload — order statistics over an *unbounded* completion stream.
:class:`Histogram` tracks them with the P² algorithm (Jain & Chlamtac,
CACM 1985): five markers per target quantile, updated per observation with
a parabolic interpolation, O(1) memory and — crucially for the bench
regression gate — fully deterministic: the same observation sequence
always yields the same estimate, so committed p50/p99 values are
comparable across PRs.  Below five observations the exact interpolated
order statistic is returned, so small sims report textbook quantiles.

:class:`ClusterMetrics` is the hook object the simulators call: construct
one, pass it as ``Cluster(..., metrics=...)``, and every scheduling event
(arrival / dispatch / finish / reject / regrant / suspend / resume) lands
in the registry, plus an event-granularity sample of queue depth, busy
workers and suspended jobs.  With ``metrics=None`` (the default) the sims
pay one ``if`` per event and nothing else.
"""

from __future__ import annotations

import json
import re

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "P2Quantile",
    "ClusterMetrics",
]

_PROM_NAME = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Prometheus metric-name sanitization: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    name = _PROM_NAME.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _prom_value(v: float | None) -> str:
    if v is None:
        return "NaN"
    return repr(float(v))


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment")
        self.value += amount

    def to_dict(self) -> float:
        return self.value


class Gauge:
    """Last-value gauge with an optional (t, value) series.

    ``set(v, t=...)`` appends a series point; consecutive points with the
    same value collapse (event loops sample densely, series stay small).
    """

    __slots__ = ("name", "value", "series")

    def __init__(self, name: str):
        self.name = name
        self.value = None
        self.series: list[tuple[float, float]] = []

    def set(self, value: float, t: float | None = None) -> None:
        self.value = float(value)
        if t is not None:
            if self.series and self.series[-1][1] == self.value:
                return
            self.series.append((float(t), self.value))

    def to_dict(self) -> dict:
        return {
            "value": self.value,
            "series": [[t, v] for t, v in self.series],
        }


class P2Quantile:
    """One streaming quantile estimate via the P² marker algorithm."""

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile p must be in (0, 1), got {p}")
        self.p = float(p)
        self.count = 0
        self._initial: list[float] = []   # first five observations, sorted
        self._q: list[float] = []         # marker heights
        self._n: list[float] = []         # marker positions (1-based)
        self._np: list[float] = []        # desired positions
        self._dn = [0.0, p / 2.0, p, (1.0 + p) / 2.0, 1.0]

    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        if self.count <= 5:
            self._initial.append(x)
            self._initial.sort()
            if self.count == 5:
                p = self.p
                self._q = list(self._initial)
                self._n = [1.0, 2.0, 3.0, 4.0, 5.0]
                self._np = [1.0, 1.0 + 2.0 * p, 1.0 + 4.0 * p,
                            3.0 + 2.0 * p, 5.0]
            return
        q, n = self._q, self._n
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            for i in range(1, 5):
                if x < q[i]:
                    k = i - 1
                    break
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            self._np[i] += self._dn[i]
        for i in (1, 2, 3):
            d = self._np[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) or (
                d <= -1.0 and n[i - 1] - n[i] < -1.0
            ):
                s = 1.0 if d > 0 else -1.0
                cand = self._parabolic(i, s)
                if not (q[i - 1] < cand < q[i + 1]):
                    cand = self._linear(i, s)
                q[i] = cand
                n[i] += s

    def _parabolic(self, i: int, d: float) -> float:
        q, n = self._q, self._n
        return q[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, d: float) -> float:
        j = i + int(d)
        q, n = self._q, self._n
        return q[i] + d * (q[j] - q[i]) / (n[j] - n[i])

    @property
    def value(self) -> float | None:
        """Current estimate: exact (interpolated) below five observations,
        the P² center marker afterwards.  None before any observation."""
        if self.count == 0:
            return None
        if self.count <= 5:
            xs = self._initial
            h = (len(xs) - 1) * self.p
            lo = int(h)
            hi = min(lo + 1, len(xs) - 1)
            return xs[lo] + (h - lo) * (xs[hi] - xs[lo])
        return self._q[2]


class Histogram:
    """Count / sum / min / max plus P² estimates at target quantiles."""

    def __init__(self, name: str, quantiles: tuple[float, ...] = (0.5, 0.99)):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._quantiles = {float(p): P2Quantile(p) for p in quantiles}

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.sum += x
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)
        for est in self._quantiles.values():
            est.add(x)

    def quantile(self, p: float) -> float | None:
        return self._quantiles[float(p)].value

    @property
    def mean(self) -> float | None:
        return self.sum / self.count if self.count else None

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "quantiles": {
                f"{p:g}": est.value for p, est in self._quantiles.items()
            },
        }


class MetricsRegistry:
    """Named counters / gauges / histograms, create-on-first-use."""

    def __init__(self):
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        if name not in self.counters:
            self.counters[name] = Counter(name)
        return self.counters[name]

    def gauge(self, name: str) -> Gauge:
        if name not in self.gauges:
            self.gauges[name] = Gauge(name)
        return self.gauges[name]

    def histogram(
        self, name: str, quantiles: tuple[float, ...] = (0.5, 0.99)
    ) -> Histogram:
        if name not in self.histograms:
            self.histograms[name] = Histogram(name, quantiles)
        return self.histograms[name]

    def to_dict(self) -> dict:
        return {
            "counters": {k: c.to_dict() for k, c in self.counters.items()},
            "gauges": {k: g.to_dict() for k, g in self.gauges.items()},
            "histograms": {
                k: h.to_dict() for k, h in self.histograms.items()
            },
        }

    def to_prom_text(self) -> str:
        """Prometheus text exposition (version 0.0.4) of the registry.

        Counters export as ``counter``, gauges as ``gauge`` (last value;
        the time series stays a JSON concern), histograms as ``summary``
        — per-quantile sample lines plus ``_sum`` / ``_count``.  Output
        is sorted by metric name so the dump is byte-stable for golden
        tests and diffable across runs.
        """
        lines: list[str] = []
        for name in sorted(self.counters):
            n = _prom_name(name)
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {_prom_value(self.counters[name].value)}")
        for name in sorted(self.gauges):
            g = self.gauges[name]
            if g.value is None:
                continue
            n = _prom_name(name)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {_prom_value(g.value)}")
        for name in sorted(self.histograms):
            h = self.histograms[name]
            n = _prom_name(name)
            lines.append(f"# TYPE {n} summary")
            for p in sorted(h._quantiles):
                lines.append(
                    f'{n}{{quantile="{p:g}"}} '
                    f"{_prom_value(h.quantile(p))}"
                )
            lines.append(f"{n}_sum {_prom_value(h.sum)}")
            lines.append(f"{n}_count {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def save_prom(self, path: str) -> None:
        with open(path, "w") as fp:
            fp.write(self.to_prom_text())


#: the quantiles every ClusterMetrics histogram tracks.
DEFAULT_QUANTILES = (0.5, 0.9, 0.99)


class ClusterMetrics:
    """The hook object ``Cluster``/``ElasticCluster`` drive at event
    granularity.  All hooks are cheap pure-Python accounting; the sims
    guard every call behind ``if self.metrics is not None``."""

    def __init__(
        self,
        quantiles: tuple[float, ...] = DEFAULT_QUANTILES,
        *,
        window_s: float | None = None,
        window_buckets: int = 8,
    ):
        self.registry = MetricsRegistry()
        r = self.registry
        self.turnaround = r.histogram("turnaround_s", quantiles)
        self.wait = r.histogram("wait_s", quantiles)
        self.regrant_overhead = r.histogram("regrant_overhead_s", quantiles)
        self._t0: float | None = None
        self._t_last: float | None = None
        self._tokens_done = 0.0
        #: service mode: sliding-window views over the last ``window_s``
        #: sim seconds (see :mod:`repro_torch.obs.windows`) next to the
        #: run-lifetime aggregates above.
        self.window_s = float(window_s) if window_s else None
        if self.window_s:
            from repro_torch.obs.windows import (
                EwmaRate,
                RollingSum,
                WindowedQuantile,
            )

            W, B = self.window_s, window_buckets
            self.win_turnaround = {
                p: WindowedQuantile(p, W, B) for p in (0.5, 0.99)
            }
            self.win_wait = {
                p: WindowedQuantile(p, W, B) for p in (0.5, 0.99)
            }
            self.win_tokens = RollingSum(W, B)
            self.win_queue = RollingSum(W, B)
            self.arrival_rate = EwmaRate(W / 4.0)
            self.completion_rate = EwmaRate(W / 4.0)

    # ---- run lifecycle ---------------------------------------------------

    def on_run_start(self, t: float) -> None:
        self._t0 = float(t)

    def sample(
        self, now: float, queue_depth: int, busy_workers: int,
        suspended_jobs: int, *, net_bytes_per_s: float | None = None,
        net_capacity: float | None = None,
    ) -> None:
        """Event-granularity gauge sample (queue / busy / suspended, plus
        — on fabric-priced runs — aggregate shuffle demand vs capacity).
        The fabric kwargs are optional so capacity-unlimited callers
        (the elastic sim) keep their positional 4-arg call unchanged."""
        r = self.registry
        r.gauge("queue_depth").set(queue_depth, t=now)
        r.gauge("busy_workers").set(busy_workers, t=now)
        r.gauge("suspended_jobs").set(suspended_jobs, t=now)
        if net_bytes_per_s is not None:
            r.gauge("fabric_bytes_per_s").set(net_bytes_per_s, t=now)
            if net_capacity:
                r.gauge("fabric_utilization").set(
                    net_bytes_per_s / net_capacity, t=now
                )
        if self.window_s:
            self.win_queue.observe(now, queue_depth)
        self._t_last = float(now)

    # ---- per-event hooks -------------------------------------------------

    def on_arrival(self, now: float, job) -> None:
        self.registry.counter("jobs_arrived").inc()
        if self.window_s:
            self.arrival_rate.observe(now)

    def on_dispatch(self, now: float, rec) -> None:
        self.registry.counter("jobs_dispatched").inc()
        if rec.wait is not None:
            self.wait.observe(rec.wait)
            if self.window_s:
                for wq in self.win_wait.values():
                    wq.observe(now, rec.wait)

    def on_finish(self, now: float, rec) -> None:
        r = self.registry
        r.counter("jobs_completed").inc()
        contention = getattr(rec, "contention_s", 0.0)
        if contention:
            r.counter("contended_jobs").inc()
            r.counter("contention_s_total").inc(float(contention))
        if rec.turnaround is not None:
            self.turnaround.observe(rec.turnaround)
            if self.window_s:
                for wq in self.win_turnaround.values():
                    wq.observe(now, rec.turnaround)
        self._tokens_done += float(rec.spec.size)
        r.counter("tokens_completed").inc(float(rec.spec.size))
        if self.window_s:
            self.win_tokens.observe(now, float(rec.spec.size))
            self.completion_rate.observe(now)
        if self._t0 is not None and now > self._t0:
            r.gauge("goodput_tokens_per_s").set(
                self._tokens_done / (now - self._t0), t=now
            )

    def on_reject(self, now: float, rec) -> None:
        self.registry.counter("jobs_rejected").inc()

    def on_regrant(self, now: float, kind: str, overhead_s: float) -> None:
        r = self.registry
        r.counter("n_regrants").inc()
        r.counter(f"n_regrants_{kind}").inc()
        self.regrant_overhead.observe(overhead_s)

    def on_suspend(self, now: float, save_s: float) -> None:
        self.registry.counter("n_suspends").inc()

    def on_resume(self, now: float, restore_s: float) -> None:
        self.registry.counter("n_resumes").inc()

    # ---- export ----------------------------------------------------------

    def windowed_summary(self, now: float | None = None) -> dict | None:
        """Last-``window_s``-seconds view (p50/p99 turnaround + wait,
        goodput, queue depth, arrival/completion rates); ``None`` when the
        metrics object was built without a window.  ``now`` defaults to
        the last sampled event time."""
        if not self.window_s:
            return None
        now = self._t_last if now is None else float(now)
        if now is None:
            return None
        return {
            "window_s": self.window_s,
            "t": now,
            "p50_turnaround_s": self.win_turnaround[0.5].value(now),
            "p99_turnaround_s": self.win_turnaround[0.99].value(now),
            "p50_wait_s": self.win_wait[0.5].value(now),
            "p99_wait_s": self.win_wait[0.99].value(now),
            "jobs_completed": self.win_turnaround[0.99].window_count(now),
            "goodput_tokens_per_s": self.win_tokens.rate(now),
            "queue_depth_mean": self.win_queue.mean(now),
            "arrival_rate_per_s": self.arrival_rate.rate(now),
            "completion_rate_per_s": self.completion_rate.rate(now),
        }

    def summary(self) -> dict:
        """The service-metric scalars the launch CLI tabulates."""
        r = self.registry
        elapsed = (
            (self._t_last - self._t0)
            if self._t0 is not None and self._t_last is not None
            and self._t_last > self._t0 else None
        )
        out = {
            "jobs_completed": r.counter("jobs_completed").value,
            "jobs_rejected": r.counter("jobs_rejected").value,
            "p50_turnaround_s": self.turnaround.quantile(0.5),
            "p99_turnaround_s": self.turnaround.quantile(0.99),
            "p50_wait_s": self.wait.quantile(0.5),
            "p99_wait_s": self.wait.quantile(0.99),
            "goodput_tokens_per_s": (
                self._tokens_done / elapsed if elapsed else None
            ),
            "n_regrants": r.counter("n_regrants").value,
            "n_suspends": r.counter("n_suspends").value,
            "regrant_overhead_total_s": self.regrant_overhead.sum,
        }
        if self.window_s:
            out["windowed"] = self.windowed_summary()
        return out

    def to_dict(self) -> dict:
        return {"summary": self.summary(), **self.registry.to_dict()}

    def save(self, path: str) -> None:
        with open(path, "w") as fp:
            json.dump(self.to_dict(), fp, indent=1, sort_keys=True)
