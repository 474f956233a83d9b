"""MapReduce engine entry points (counterpart of ``repro.mapreduce.engine``).

Hadoop's concepts map onto the port as they do in the reference: M map
and R reduce tasks run over W worker slots in ``ceil(M/W)`` /
``ceil(R/W)`` waves; each task pays a fixed setup compute (the JVM-start
analogue) plus its spill sort; the shuffle hashes keys to reducers into
capacity-bounded partitions; reducers aggregate sorted runs through a
pluggable reduce backend.  That slot scheduling is what makes total time
depend on (M, R) the way the paper models.

``build_job`` runs the plan's fused mode, its traced mode when given a
telemetry recorder, and its pipelined mode at ``overlap_depth > 1``, as
the reference's does.  A collective shuffle (``all_to_all``) needs a
``torch.distributed`` process group, the reference's mesh, and runs the
plan's sharded mode (:func:`build_job_sharded`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.mapreduce import backends as _backends
from repro_torch.mapreduce.phases import PAD_KEY
from repro_torch.mapreduce.plan import ExecutionPlan


@dataclasses.dataclass(frozen=True)
class JobConfig:
    """One MapReduce experiment configuration (the paper's parameter set)."""

    num_mappers: int            # M: map tasks       (paper parameter 1)
    num_reducers: int           # R: reduce tasks    (paper parameter 2)
    num_workers: int = 1        # W: parallel worker slots (cluster size)
    combiner: bool = False      # map-side combine stage between map and
    #                             shuffle; needs a commutative+associative
    #                             reduce_op (the plan rejects "first")
    capacity_factor: float = 4.0  # reducer partition capacity multiplier
    setup_rounds: int = 4       # per-task startup overhead (matmul rounds)
    setup_dim: int = 32         # startup compute size
    reduce_backend: str = "torch"   # "torch" | "scatter_reduce" | "cuda"
    shuffle_backend: str = "lexsort"  # "lexsort" | "all_to_all"
    overlap_depth: int = 1          # software-pipeline depth (1 = serial)

    def __post_init__(self):
        if self.num_mappers < 1 or self.num_reducers < 1 or self.num_workers < 1:
            raise ValueError(f"bad config {self}")
        if self.overlap_depth < 1:
            raise ValueError(
                f"overlap_depth must be >= 1, got {self.overlap_depth}"
            )
        _backends.get_reduce_backend(self.reduce_backend)
        _backends.get_shuffle_backend(self.shuffle_backend)

    @property
    def map_waves(self) -> int:
        return math.ceil(self.num_mappers / self.num_workers)

    @property
    def reduce_waves(self) -> int:
        return math.ceil(self.num_reducers / self.num_workers)


@dataclasses.dataclass(frozen=True)
class MapReduceApp:
    """A MapReduce application: map emits (key, value) pairs; reduce
    aggregates values per key with ``reduce_op``.  ``sum`` and ``max`` are
    combiner-eligible; ``first`` is order-dependent.
    """

    name: str
    key_space: int
    # map_fn(tokens (W, S), valid (W, S)) -> keys, values, valid (W, P)
    map_fn: Callable
    pairs_per_token: int = 1
    reduce_op: str = "sum"  # "sum" | "max" | "first"


def build_job(app: MapReduceApp, cfg: JobConfig, input_len: int, *,
              group=None, recorder=None, device="cuda"):
    """Lower a full MapReduce job for one (app, config, input size).

    Returns ``job(tokens (input_len,) int32) -> (out_keys (R, C),
    out_vals (R, C), dropped ())``, all on ``device``.

    ``cfg.shuffle_backend`` selects the execution strategy: a collective
    backend (``"all_to_all"``) needs ``group``, a ``torch.distributed``
    process group of ``cfg.num_workers`` ranks, and routes through
    :func:`build_job_sharded`; the default ``"lexsort"`` runs the
    single-controller pipeline.

    ``recorder`` (optional) turns on per-phase telemetry: any object with
    the :class:`repro_torch.telemetry.PhaseRecorder` protocol
    (``start_job(app_name, cfg, input_len) -> trace``, the trace with
    ``record_phase(name, wall_s, **counters)`` and ``finish(total_s)``).
    The phases are then fenced and wall-clocked, and each call of the job
    appends one trace.  Without one, ``cfg.overlap_depth > 1`` runs the
    pipelined mode and depth 1 the fused mode, which costs nothing extra.
    """
    shuffle = _backends.get_shuffle_backend(cfg.shuffle_backend)
    if shuffle.collective:
        if group is None:
            raise ValueError(
                f"shuffle backend {shuffle.name!r} is a collective; pass "
                "group= (a torch.distributed process group) or call "
                "build_job_sharded"
            )
        return build_job_sharded(app, cfg, input_len, group,
                                 recorder=recorder, device=device)
    if group is not None:
        raise ValueError(
            f"group given but shuffle backend {shuffle.name!r} is "
            "single-controller; use shuffle_backend=\"all_to_all\" for a "
            "distributed job"
        )
    plan = ExecutionPlan(app, cfg, input_len, device=device)
    if recorder is not None:
        return plan.traced(recorder)
    if cfg.overlap_depth > 1:
        return plan.pipelined()
    return plan.fused()


def build_job_sharded(app: MapReduceApp, cfg: JobConfig, input_len: int,
                      group, counters: bool = False, recorder=None,
                      device="cuda"):
    """The job on a ``torch.distributed`` process group: this rank is one
    of W = ``group.size()`` workers and the shuffle is
    ``all_to_all_single`` (:meth:`ExecutionPlan.sharded`; ``group=None``
    is the default world group).  Every rank returns the whole
    reducer-major output.

    With ``counters=True`` the job yields ``(out_keys, out_vals, dropped,
    stats)``, ``stats`` reducing the per-worker overflow counters::

        stats = {
            "dropped_send": int,   # shuffle send-buffer overflow, all workers
            "dropped_recv": int,   # reduce-bucket overflow, all workers
            "dropped_per_worker": (W, 2) ndarray,  # [send, recv] per worker
        }

    With ``recorder=`` the phases are fenced and every call appends a
    per-phase :class:`~repro_torch.telemetry.JobTrace`.
    """
    plan = ExecutionPlan(app, cfg, input_len, device=device)
    return plan.sharded(group, counters=counters, recorder=recorder)


def collect_results(out_keys, out_vals) -> dict[int, int]:
    """Gather (key -> aggregated value) from job output, host-side."""
    out_keys = torch.as_tensor(out_keys).cpu().numpy().ravel()
    out_vals = torch.as_tensor(out_vals).cpu().numpy().ravel()
    mask = out_keys != PAD_KEY
    result: dict[int, int] = {}
    for k, v in zip(out_keys[mask].tolist(), out_vals[mask].tolist()):
        result[k] = result.get(k, 0) + v
    return result
