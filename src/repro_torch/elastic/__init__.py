"""Elastic execution: checkpointable jobs and regrant economics
(counterpart of ``repro.elastic``).

    snapshot.py  — wave-boundary job state: JobCursor + ElasticState,
                   persisted through repro_torch.checkpoint (atomic
                   commit, keep= retention, template-free restore) in the
                   reference's layout
    resumable.py — ResumableJob / run_resumable: stop at a wave boundary,
                   snapshot, re-plan under another grant W, resume
                   bit-identically
    regrant.py   — WorkProgress + RegrantCostModel: predicted remaining
                   time under W' plus measured snapshot/restore overhead
                   against remaining time under W
    sim.py       — ElasticCluster: the event-driven simulator grown
                   preempt/resume/regrant events, shrink/grow worker
                   accounting with conservation invariants, and
                   segment-summed telemetry traces

Entry points: the ``predict-elastic`` policy
(:mod:`repro_torch.cluster.policies`) and ``python -m
repro_torch.launch.cluster --elastic --policies predict-elastic`` (CLI).
"""

from repro_torch.elastic.regrant import (
    RegrantCostModel,
    RegrantDecision,
    WorkProgress,
)
from repro_torch.elastic.resumable import ResumableJob, run_resumable
from repro_torch.elastic.sim import (
    ElasticCluster,
    Regrant,
    RunningView,
    SuspendedView,
)
from repro_torch.elastic.snapshot import (
    SNAPSHOT_VERSION,
    ElasticState,
    JobCursor,
    load_snapshot,
    save_snapshot,
    state_to_tree,
    tree_to_state,
)

__all__ = [
    "SNAPSHOT_VERSION",
    "ElasticCluster",
    "ElasticState",
    "JobCursor",
    "Regrant",
    "RegrantCostModel",
    "RegrantDecision",
    "ResumableJob",
    "RunningView",
    "SuspendedView",
    "WorkProgress",
    "load_snapshot",
    "run_resumable",
    "save_snapshot",
    "state_to_tree",
    "tree_to_state",
]
