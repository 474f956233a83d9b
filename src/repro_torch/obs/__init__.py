"""Cluster-wide observability: spans, service metrics, drift alarms
(counterpart of ``repro.obs``).

The paper's method *is* observation — profiling runs feed the regression
that predicts total time — but the telemetry layer's
:class:`~repro_torch.telemetry.JobTrace` only ever sees one job.  This package is the cluster-wide layer on top:

    log.py     — leveled structured logging (text or JSON-lines), the
                 replacement for bare ``print`` in long sim runs
    metrics.py — counters / gauges / deterministic P² streaming-quantile
                 histograms + the ``ClusterMetrics`` hook object the
                 simulators call at event granularity (p50/p99 turnaround,
                 wait, goodput, regrant overhead)
    spans.py   — ``SpanRecorder``: the causal tree cluster-run → job →
                 segment → wave/phase assembled from data the sims already
                 produce, exported as Chrome trace-event JSON (Perfetto)
                 with per-worker-slot tracks and counter tracks
    resources.py — ``ResourceTimeline``: per-job cpu_s/net_bytes phase
                 counters folded into cluster-wide utilization series
                 (fabric bytes/s vs net_capacity, busy CPU vs W), with
                 over-capacity episode detection, registry gauges, and
                 pid 4 Chrome counter tracks
    drift.py   — ``PredictionLedger``: every oracle estimate recorded
                 against the realized wall per (app, backend, depth)
                 category; EWMA absolute-relative-error raises a
                 ``DriftAlarm`` that :class:`~repro_torch.cluster.online.
                 OnlineRefiner.refit_category` consumes
    windows.py — sim-time sliding windows: bucketed P² quantiles with
                 deterministic merge, EWMA rates, rolling sums — the
                 "last W seconds" view service mode runs on
    slo.py     — ``SLOMonitor``: multi-window burn-rate alarms and
                 error-budget accounting against an ``SLOPolicy``
    controller.py — ``OverloadController`` + ``ControlledPolicy``: the
                 alarm→action loop (shed / suspend-to-disk / resume)
                 with an auditable decision log, and the
                 ``StaticAdmission`` baseline it is benchmarked against

Everything here is strictly opt-in: ``Cluster(..., metrics=None)`` is the
default and costs one ``if`` per event; the engine's fused mode is never
touched (span assembly is post-hoc, from completed :class:`JobRecord`\\ s).
"""

from repro_torch.obs.log import LEVELS, Logger, get_logger
from repro_torch.obs.metrics import (
    ClusterMetrics,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    P2Quantile,
)
from repro_torch.obs.resources import RESOURCE_PID, ResourceTimeline
from repro_torch.obs.spans import (
    Span,
    SpanRecorder,
    build_span_tree,
    check_span_tiling,
    render_slots,
    to_chrome_trace,
    validate_chrome_trace,
)
from repro_torch.obs.drift import (
    LEDGER_SCHEMA_VERSION,
    DriftAlarm,
    PredictionLedger,
)
from repro_torch.obs.windows import (
    EwmaRate,
    RollingSum,
    WindowedQuantile,
    weighted_quantile,
)
from repro_torch.obs.slo import BurnAlarm, SLOMonitor, SLOPolicy
from repro_torch.obs.controller import (
    ControlAction,
    ControlledPolicy,
    OverloadController,
    StaticAdmission,
)

__all__ = [
    "LEVELS",
    "Logger",
    "get_logger",
    "ClusterMetrics",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "P2Quantile",
    "RESOURCE_PID",
    "ResourceTimeline",
    "Span",
    "SpanRecorder",
    "build_span_tree",
    "check_span_tiling",
    "render_slots",
    "to_chrome_trace",
    "validate_chrome_trace",
    "DriftAlarm",
    "LEDGER_SCHEMA_VERSION",
    "PredictionLedger",
    "EwmaRate",
    "RollingSum",
    "WindowedQuantile",
    "weighted_quantile",
    "BurnAlarm",
    "SLOMonitor",
    "SLOPolicy",
    "ControlAction",
    "ControlledPolicy",
    "OverloadController",
    "StaticAdmission",
]
