"""Regrant economics (counterpart of ``repro.elastic.regrant``): is
shrinking or growing a running job's grant worth it?

The paper's regression models predict a job's *total* time at any
(M, R, W) — which is exactly what a mid-flight re-provisioning decision
needs (arXiv:1203.4367's argument): compare the predicted time to finish
the remaining waves under the current grant W against the predicted time
under a candidate grant W' *plus* the measured snapshot/restore overhead.

:class:`WorkProgress` is the scheduler-visible cursor (task counts only —
no engine buffers), shared between the elastic cluster simulator's
accounting and this cost model.  :class:`RegrantCostModel` scales
model-predicted totals by the wave-quantized remaining-work fraction; it
deliberately consumes *predictions* (the paper's regression basis, via
whatever model the calling policy has fitted) and *measured* overheads
(EWMA over observed snapshot/restore walls, seeded with configured
estimates), never oracle truth.
"""

from __future__ import annotations

import dataclasses


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class WorkProgress:
    """Wave-boundary progress of one job, in task space.

    The same denomination as :class:`repro_torch.elastic.snapshot.JobCursor`
    (tasks, not waves) so the fraction-remaining math is grant-agnostic.
    """

    mappers: int
    reducers: int
    map_tasks_done: int = 0
    shuffled: bool = False
    reduce_tasks_done: int = 0
    #: barrier steps between map and shuffle (1 when the job runs a
    #: map-side combiner, else 0) and whether the barrier has passed —
    #: combiner jobs have one more wave-boundary step, and the regrant
    #: cost model must price the remaining fraction against it.
    combine_steps: int = 0
    combined: bool = False

    def __post_init__(self):
        if self.mappers < 1 or self.reducers < 1:
            raise ValueError(f"bad progress {self}")
        if self.combine_steps not in (0, 1):
            raise ValueError(f"bad progress {self}")

    @property
    def done(self) -> bool:
        return self.shuffled and self.reduce_tasks_done >= self.reducers

    def steps_total(self, workers: int) -> int:
        return (
            _ceil_div(self.mappers, workers) + self.combine_steps + 1
            + _ceil_div(self.reducers, workers)
        )

    def steps_remaining(self, workers: int) -> int:
        return (
            _ceil_div(max(0, self.mappers - self.map_tasks_done), workers)
            + (0 if self.combined else self.combine_steps)
            + (0 if self.shuffled else 1)
            + _ceil_div(
                max(0, self.reducers - self.reduce_tasks_done), workers
            )
        )

    def remaining_fraction(self, workers: int) -> float:
        """Wave-quantized fraction of the job still ahead under a grant."""
        return self.steps_remaining(workers) / self.steps_total(workers)


@dataclasses.dataclass(frozen=True)
class RegrantDecision:
    """The cost model's answer for one candidate regrant."""

    current_workers: int
    new_workers: int
    t_remaining_current: float   # predicted: finish under current grant
    t_remaining_new: float       # predicted: finish under candidate grant
    overhead_s: float            # measured snapshot + restore cost
    gain_s: float                # t_rem_current - (t_rem_new + overhead)
    worth_it: bool               # gain_s > min_gain_s (speed-motivated move)
    shrink_ok: bool              # job-side gate for externally-motivated
    #                              shrinks (enough work left, overhead small
    #                              relative to the remaining run)


class RegrantCostModel:
    """Prices a candidate regrant from predictions + measured overheads.

    Two kinds of moves ask different questions:

    * a **grow** (or any speed-motivated regrant) is worth it when the
      job itself finishes earlier even after paying the checkpoint:
      ``worth_it`` = gain above ``min_gain_s``;
    * a **shrink** is externally motivated (the scheduler wants the
      workers for a deadline-risk job), so the job-side question is only
      whether the move is *cheap*: ``shrink_ok`` demands at least
      ``min_remaining_frac`` of the job still ahead (never checkpoint a
      nearly-finished job) and overhead at most ``max_overhead_frac`` of
      the remaining run.  Whether the freed workers buy anything is the
      policy's side of the ledger.

    ``record_overhead`` folds *measured* snapshot/restore walls (from
    :func:`repro_torch.elastic.snapshot.save_snapshot` / ``load_snapshot``, or
    the simulator's configured costs) into an EWMA, so the model tracks
    the real price of a preemption as the system runs.
    """

    def __init__(
        self,
        *,
        snapshot_overhead_s: float = 0.02,
        restore_overhead_s: float = 0.02,
        min_gain_s: float = 0.0,
        min_remaining_frac: float = 0.15,
        max_overhead_frac: float = 0.25,
        ewma_alpha: float = 0.3,
    ):
        if snapshot_overhead_s < 0 or restore_overhead_s < 0:
            raise ValueError("overheads must be >= 0")
        if not 0 < ewma_alpha <= 1:
            raise ValueError("ewma_alpha must be in (0, 1]")
        self.snapshot_overhead_s = float(snapshot_overhead_s)
        self.restore_overhead_s = float(restore_overhead_s)
        self.min_gain_s = float(min_gain_s)
        self.min_remaining_frac = float(min_remaining_frac)
        self.max_overhead_frac = float(max_overhead_frac)
        self.ewma_alpha = float(ewma_alpha)
        self.n_observed = 0

    @property
    def overhead_s(self) -> float:
        return self.snapshot_overhead_s + self.restore_overhead_s

    def record_overhead(self, save_s: float, restore_s: float) -> None:
        """Fold one measured (snapshot, restore) wall pair into the EWMA."""
        a = self.ewma_alpha
        self.snapshot_overhead_s = (
            (1 - a) * self.snapshot_overhead_s + a * float(save_s)
        )
        self.restore_overhead_s = (
            (1 - a) * self.restore_overhead_s + a * float(restore_s)
        )
        self.n_observed += 1

    def evaluate(
        self,
        *,
        t_total_current: float,
        t_total_new: float,
        progress: WorkProgress,
        current_workers: int,
        new_workers: int,
    ) -> RegrantDecision:
        """Price one candidate regrant.

        ``t_total_current`` / ``t_total_new``: model-predicted *total* job
        times at the current / candidate grant (the paper's regression
        evaluated at (M, R, W, size) and (M, R, W', size)) — scaled here
        by each grant's own wave-quantized remaining fraction, because
        wave counts requantize when the grant changes.
        """
        if current_workers < 1 or new_workers < 1:
            raise ValueError("worker grants must be >= 1")
        frac_cur = progress.remaining_fraction(current_workers)
        t_rem_cur = float(t_total_current) * frac_cur
        t_rem_new = (
            float(t_total_new) * progress.remaining_fraction(new_workers)
        )
        overhead = self.overhead_s
        gain = t_rem_cur - (t_rem_new + overhead)
        shrink_ok = (
            frac_cur >= self.min_remaining_frac
            and overhead <= self.max_overhead_frac * max(t_rem_cur, 1e-12)
        )
        return RegrantDecision(
            current_workers=current_workers,
            new_workers=new_workers,
            t_remaining_current=t_rem_cur,
            t_remaining_new=t_rem_new,
            overhead_s=overhead,
            gain_s=gain,
            worth_it=gain > self.min_gain_s,
            shrink_ok=shrink_ok,
        )
