"""Per-phase telemetry and decomposed cost models (counterpart of
``repro.telemetry``).

    trace.py  — PhaseStats / JobTrace / PhaseRecorder: per-phase wall times
                and resource counters with checkable conservation laws;
                thread a recorder through ``build_job(recorder=)``, which
                runs the plan's traced mode
    models.py — one regression per (phase, resource) on the paper's basis,
                a composed total-time prediction, and ModelDatabase storage
                under resource-qualified keys
    estimator.py — static per-phase flops and bytes from one shape-only
                (``device="meta"``) run of each phase function, in place of
                the reference's XLA cost analysis
"""

from repro_torch.telemetry.trace import (
    PAIR_BYTES,
    TRACE_SCHEMA_VERSION,
    JobTrace,
    PhaseRecorder,
    PhaseStats,
    collect_traced,
)
from repro_torch.telemetry.estimator import (
    estimates_available,
    stage_cost_estimates,
)
from repro_torch.telemetry.models import (
    DEFAULT_COUNTER_TARGETS,
    PHASE_ORDER,
    TIME_RESOURCE,
    PhaseModelSet,
    composed_vs_monolithic,
    fit_phase_models,
    phase_resource_key,
    split_resource_key,
    targets_from_traces,
)

__all__ = [
    "PAIR_BYTES",
    "TRACE_SCHEMA_VERSION",
    "JobTrace",
    "PhaseRecorder",
    "PhaseStats",
    "collect_traced",
    "DEFAULT_COUNTER_TARGETS",
    "PHASE_ORDER",
    "TIME_RESOURCE",
    "PhaseModelSet",
    "composed_vs_monolithic",
    "estimates_available",
    "fit_phase_models",
    "phase_resource_key",
    "split_resource_key",
    "stage_cost_estimates",
    "targets_from_traces",
]
