"""Wave-boundary job state: cursors, snapshots, checkpoint persistence
(counterpart of ``repro.elastic.snapshot``).

A MapReduce job has clean interruption points only at wave boundaries:
between map waves, at the combine and shuffle barriers, and between
reduce waves.  At such a boundary its state is

* :class:`JobCursor` — the scalar progress record (tasks done, barriers
  passed, the monotone wave counter, the current worker grant), counted in
  tasks, not waves, since waves depend on the grant;
* :class:`ElasticState` — the cursor plus the canonical buffers
  (task-major, exactly M or R rows), so a job preempted under W resumes
  bit-identically under W'.

:func:`save_snapshot` / :func:`load_snapshot` persist a state through a
:class:`repro_torch.checkpoint.CheckpointManager` as a nested-dict tree of
numpy leaves plus one unicode leaf carrying the cursor as JSON: the
reference's snapshot layout, so a snapshot taken by either package loads
in the other (``repro_torch.convert.snapshot_from_reference`` renames the
reduce backend).  The engine is deterministic per task, so the cursor's
``waves_executed`` is the job's only counter state.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.elastic.regrant import WorkProgress

#: snapshot schema version (bump on layout changes; load refuses unknowns).
SNAPSHOT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class JobCursor:
    """Scalar progress of one job at a wave boundary.

    Identity fields (``app`` .. ``shuffle_backend``) pin the job to its
    configuration; ``workers`` is the current grant and the only field
    :meth:`repro_torch.elastic.ResumableJob.regrant` changes.
    """

    app: str
    input_len: int
    mappers: int
    reducers: int
    workers: int
    combiner: bool
    capacity_factor: float
    setup_rounds: int
    setup_dim: int
    reduce_backend: str
    shuffle_backend: str
    map_tasks_done: int = 0
    combined: bool = False      # map-side combine barrier passed
    shuffled: bool = False
    partition_cap: int = 0      # partition width, fixed at shuffle time
    reduce_tasks_done: int = 0
    waves_executed: int = 0     # monotone step counter (the counter state)
    dropped: int = 0            # shuffle overflow accounting, set at shuffle

    def __post_init__(self):
        if not (0 <= self.map_tasks_done <= self.mappers + self.workers):
            raise ValueError(f"bad cursor {self}")
        if self.workers < 1:
            raise ValueError("cursor workers must be >= 1")

    # The wave arithmetic lives in WorkProgress alone, so the cursor and
    # the regrant cost model agree on what a remaining wave is.

    def progress(self) -> WorkProgress:
        return WorkProgress(
            mappers=self.mappers, reducers=self.reducers,
            map_tasks_done=self.map_tasks_done, shuffled=self.shuffled,
            reduce_tasks_done=self.reduce_tasks_done,
            combine_steps=1 if self.combiner else 0,
            combined=self.combined,
        )

    @property
    def done(self) -> bool:
        return self.progress().done

    @property
    def map_done(self) -> bool:
        return self.map_tasks_done >= self.mappers

    def steps_total(self, workers: int | None = None) -> int:
        """Wave-boundary steps of the whole job under a grant: map waves,
        the combine barrier (combiner jobs), the shuffle, reduce waves."""
        return self.progress().steps_total(
            self.workers if workers is None else workers
        )

    def steps_remaining(self, workers: int | None = None) -> int:
        return self.progress().steps_remaining(
            self.workers if workers is None else workers
        )

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["_version"] = SNAPSHOT_VERSION
        return json.dumps(d, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "JobCursor":
        d = json.loads(s)
        version = d.pop("_version", None)
        if version != SNAPSHOT_VERSION:
            raise ValueError(
                f"unsupported snapshot version {version!r} "
                f"(this build reads {SNAPSHOT_VERSION})"
            )
        return JobCursor(**d)


@dataclasses.dataclass
class ElasticState:
    """Cursor + canonical buffers: everything a job needs to resume.

    ``arrays`` (tensors on the job's device) by phase of life:

    * before the shuffle: ``map_keys`` / ``map_vals`` / ``map_valid``, the
      (M, P) task-major map accumulators (rows past
      ``cursor.map_tasks_done`` hold PAD_KEY / 0 / False), (M, Pc) after
      the combine barrier;
    * from the shuffle on: ``part_keys`` / ``part_vals``, the (R, cap)
      reduce partitions, and ``out_keys`` / ``out_vals``, the (R, cap)
      reduce outputs (rows not yet reduced hold PAD_KEY / 0).
    """

    cursor: JobCursor
    arrays: dict


def state_to_tree(state: ElasticState) -> dict:
    """A state as a nested-dict tree of numpy leaves; the cursor rides as a
    0-d unicode leaf (JSON), which ``np.save(allow_pickle=False)`` stores."""
    return {
        "cursor": np.asarray(state.cursor.to_json()),
        "arrays": {
            k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v)
            for k, v in state.arrays.items()
        },
    }


def tree_to_state(tree: dict, device="cuda") -> ElasticState:
    """The state of a tree from :func:`state_to_tree` (or the reference's),
    its arrays as tensors on ``device``."""
    cursor = JobCursor.from_json(str(np.asarray(tree["cursor"])[()]))
    arrays = {k: torch.as_tensor(np.asarray(v), device=device)
              for k, v in tree["arrays"].items()}
    return ElasticState(cursor=cursor, arrays=arrays)


def save_snapshot(manager, state: ElasticState, step: int | None = None,
                  ) -> tuple[int, float]:
    """Persist a wave-boundary snapshot through ``manager``.

    ``step`` defaults to the cursor's ``waves_executed``, so successive
    snapshots of one job land in distinct slots and ``keep=`` applies
    across them.  Returns ``(step, wall_seconds)``: the save overhead that
    :meth:`RegrantCostModel.record_overhead` charges for a preemption.
    """
    if step is None:
        step = state.cursor.waves_executed
    t0 = time.perf_counter()
    manager.save(step, state_to_tree(state))
    return step, time.perf_counter() - t0


def load_snapshot(manager, step: int | None = None, device="cuda",
                  ) -> tuple[ElasticState, int, float]:
    """Restore a snapshot (latest by default) onto ``device``:
    ``(state, step, wall_seconds)``.  Template-free: the manifest carries
    the key-paths, shapes and dtypes, so the restoring process needs no
    knowledge of the grant the job was preempted under."""
    t0 = time.perf_counter()
    tree, step = manager.restore(step, like=None)
    state = tree_to_state(tree, device)
    if state.arrays and next(iter(state.arrays.values())).is_cuda:
        torch.cuda.synchronize()
    return state, step, time.perf_counter() - t0
