"""Predictive cluster scheduling: the multi-job layer the paper motivates
(counterpart of ``repro.cluster``).

The paper models (config → total execution time) so that a scheduler can
make smarter decisions; this package is that scheduler.  Layering:

    workload.py — deterministic heterogeneous job traces (arrival
                  processes, log-uniform sizes, optional deadlines)
    streams.py  — open-ended arrival streams for service mode (diurnal /
                  bursty / flash-crowd rates, Poisson thinning,
                  ``JobStream``) consumed by ``Cluster.run_service``
    oracle.py   — "true" runtime sources: AnalyticOracle (closed-form,
                  Hadoop-shaped, per-job deterministic noise) and
                  EngineOracle (wall-clocks the live MapReduce engine)
    cluster.py  — event-driven simulator: W shared workers, per-job
                  grants, lifecycle accounting, invariant enforcement
    policies.py — FIFO baseline + prediction-driven policies (SJF,
                  deadline admission control) on a shared ModelDatabase,
                  with a name registry
    online.py   — continuous profiling: completed jobs refit the models

Entry points: ``python -m repro_torch.launch.cluster`` (CLI) and the
walkthrough ``python -m repro_torch.cluster_sim``.  The reference's
``cluster`` benchmark section is not ported yet.

The port names the reduce backends ``torch`` / ``scatter_reduce`` /
``cuda`` where the reference names them ``jnp`` / ``xla`` / ``pallas``
(``repro_torch.convert.REFERENCE_BACKEND_NAMES``); model databases cross
between the two through ``convert.model_database_from_reference`` and
``model_database_to_reference``.
"""

from repro_torch.cluster.cluster import (
    Cluster,
    Dispatch,
    JobRecord,
    Plan,
    Reject,
    TraceResult,
)
from repro_torch.cluster.online import OnlineRefiner
from repro_torch.cluster.streams import (
    JobStream,
    PoissonProcess,
    RenewalProcess,
    constant_rate,
    diurnal_rate,
    flash_crowd_rate,
    merge_processes,
    take,
)
from repro_torch.cluster.oracle import AnalyticOracle, EngineOracle
from repro_torch.cluster.policies import (
    POLICIES,
    DeadlineAware,
    ElasticDeadline,
    PredictedSJF,
    PredictiveFIFO,
    PredictivePolicy,
    ResourceAware,
    SchedulingPolicy,
    StaticFIFO,
    get_policy,
    register_policy,
)
from repro_torch.cluster.workload import (
    APPS,
    JobSpec,
    assign_deadlines,
    generate_workload,
)

__all__ = [
    "APPS",
    "AnalyticOracle",
    "Cluster",
    "DeadlineAware",
    "Dispatch",
    "ElasticDeadline",
    "EngineOracle",
    "JobRecord",
    "JobSpec",
    "JobStream",
    "OnlineRefiner",
    "POLICIES",
    "Plan",
    "PoissonProcess",
    "PredictedSJF",
    "PredictiveFIFO",
    "PredictivePolicy",
    "Reject",
    "RenewalProcess",
    "ResourceAware",
    "SchedulingPolicy",
    "StaticFIFO",
    "TraceResult",
    "assign_deadlines",
    "constant_rate",
    "diurnal_rate",
    "flash_crowd_rate",
    "generate_workload",
    "get_policy",
    "merge_processes",
    "register_policy",
    "take",
]
