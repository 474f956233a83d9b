"""Alarm-driven overload control: burn-rate alarms become cluster actions
(counterpart of ``repro.obs.controller``).

:class:`~repro_torch.obs.slo.SLOMonitor` says *when* the service is burning its
error budget; this module decides *what to do about it*.  The loop closes
through the existing policy interface — :class:`ControlledPolicy` wraps
any scheduling policy and consults an admission controller before every
``select``/``idle`` call, so no simulator change is needed:

* **shed** — while the alarm is tripped, queued jobs are rejected from
  the *head* of the queue down to ``queue_floor``.  Drop-head, not
  drop-tail: under overload the oldest queued job carries the deepest
  sunk delay and is already doomed to blow the target, so shedding it
  (rather than a fresh arrival that can still finish good) converts
  doomed waits into rejections instead of bad completions.
* **suspend** — with an elastic cluster bound, up to ``max_suspended``
  running best-effort jobs are throttled through the suspend-to-disk
  valve (``Regrant(job, 0)``), freeing whole grants for the backlog.
* **resume** — once the alarm clears (budget recovering), or whenever the
  queue is empty (drain safety: a suspended job must never outlive the
  run), suspended jobs are regranted oldest-first from the free pool.

Every decision lands in an auditable log of :class:`ControlAction`\\ s —
trips, clears, and each shed/suspend/resume with the burn rates that
justified it — which ``to_chrome_trace(control_log=…)`` renders as
instant events plus burn-rate counter tracks.

:class:`StaticAdmission` is the experimental control: the same wrapper
driving a fixed queue cap with no alarm, the strawman the reference's
service benchmark requires burn-rate control to strictly beat on both p99
turnaround and goodput.
"""

from __future__ import annotations

import dataclasses

from repro_torch.cluster.cluster import Reject
from repro_torch.obs.slo import SLOMonitor

__all__ = [
    "ControlAction",
    "ControlledPolicy",
    "OverloadController",
    "StaticAdmission",
]


@dataclasses.dataclass(frozen=True)
class ControlAction:
    """One audited control decision (or alarm transition)."""

    t: float
    action: str            #: "trip" | "clear" | "shed" | "suspend" | "resume"
    job_id: int | None
    reason: str
    burn_fast: float
    burn_slow: float


class OverloadController:
    """Burn-rate-driven admission/suspend controller.

    ``decide`` is consulted before the wrapped policy on every scheduling
    event and returns at most one cluster action (``Reject`` /
    ``Regrant`` / ``None``); the simulator's select loop re-asks until it
    returns ``None``, so a deep backlog sheds one job per iteration, each
    with its own audit entry.
    """

    name = "burn-control"

    def __init__(
        self,
        monitor: SLOMonitor,
        *,
        queue_floor: int = 4,
        max_suspended: int = 2,
        suspend: bool = True,
    ):
        if queue_floor < 0 or max_suspended < 0:
            raise ValueError("queue_floor and max_suspended must be >= 0")
        self.monitor = monitor
        self.queue_floor = int(queue_floor)
        self.max_suspended = int(max_suspended)
        self.suspend = bool(suspend)
        self.log: list[ControlAction] = []
        self._cluster = None

    # ------------------------------------------------------------- wiring

    def bind(self, cluster) -> None:
        """Learn the cluster; the suspend valve needs elastic support."""
        self._cluster = (
            cluster if getattr(cluster, "supports_elastic", False) else None
        )

    def observe(self, record) -> None:
        if record.finish is None:
            return
        self.monitor.observe(
            record.finish, record.turnaround, record.met_deadline
        )

    # ------------------------------------------------------------ decision

    def _log(self, t, action, job_id, reason, fast, slow) -> None:
        self.log.append(ControlAction(
            t=float(t), action=action, job_id=job_id, reason=reason,
            burn_fast=fast, burn_slow=slow,
        ))

    def decide(self, queue, free_workers: int, now: float):
        """One control decision for the current scheduling event."""
        alarm = self.monitor.update(now)
        fast, slow = self.monitor.burn_rates(now)
        if alarm is not None:
            self._log(
                now, alarm.event, None,
                f"burn fast={alarm.burn_fast:.2f} "
                f"slow={alarm.burn_slow:.2f} vs "
                f"trip>{self.monitor.trip_burn:g} "
                f"clear<{self.monitor.clear_burn:g}",
                alarm.burn_fast, alarm.burn_slow,
            )
        if self.monitor.tripped and queue:
            if len(queue) > self.queue_floor:
                # Drop-head: the oldest queued job has the deepest sunk
                # delay and is already doomed to blow the target, while a
                # fresh arrival behind a short queue can still finish
                # good — shedding it would burn budget for nothing.
                victim = queue[0]
                self._log(
                    now, "shed", victim.job_id,
                    f"queue {len(queue)} > floor {self.queue_floor} "
                    "while burn alarm tripped",
                    fast, slow,
                )
                return Reject(victim, "shed by burn-rate overload control")
            action = self._try_suspend(now, fast, slow)
            if action is not None:
                return action
        if not self.monitor.tripped:
            # Budget recovered: pull suspended jobs back.
            return self._try_resume(now, free_workers, fast, slow)
        if not queue and self._cluster is not None and (
            free_workers >= self._cluster.total_workers
        ):
            # Drain safety while still tripped: a fully idle cluster has
            # nothing left but its suspended jobs, so resume them even
            # under alarm — both to avoid stranding them at stream end
            # and because holding capacity idle sheds nothing.  (Merely
            # *momentary* empty queues mid-overload don't qualify; they
            # would churn the valve.)
            return self._try_resume(now, free_workers, fast, slow)
        return None

    def _try_suspend(self, now, fast, slow):
        if not self.suspend or self._cluster is None:
            return None
        if fast <= self.monitor.trip_burn:
            # The valve is emergency pressure relief: open it only under
            # *active* fast burn, not merely while the alarm is latched —
            # otherwise the long tripped tail after an overload cycles
            # jobs through suspend/resume for nothing.
            return None
        from repro_torch.elastic.sim import Regrant

        running = self._cluster.running_jobs(now)
        n_susp = len(self._cluster.suspended_jobs()) + sum(
            1 for r in running if r.pending_workers == 0
        )
        if n_susp >= self.max_suspended:
            return None
        victims = [
            r for r in running
            if r.spec.deadline is None          # best-effort only
            and r.pending_workers is None       # no regrant in flight
            and r.steps_remaining >= 2          # suspend needs a boundary
        ]
        if not victims:
            return None
        victim = max(victims, key=lambda r: (r.steps_remaining, r.job_id))
        self._log(
            now, "suspend", victim.job_id,
            f"valve open ({n_susp}/{self.max_suspended} suspended), "
            f"frees {victim.workers} workers",
            fast, slow,
        )
        return Regrant(
            victim.job_id, 0, reason="overload: suspend-to-disk valve"
        )

    def _try_resume(self, now, free_workers, fast, slow):
        if self._cluster is None or free_workers < 1:
            return None
        from repro_torch.elastic.sim import Regrant

        suspended = self._cluster.suspended_jobs(now)
        if not suspended:
            return None
        job = suspended[0]                      # oldest first
        workers = min(free_workers, job.workers_before)
        self._log(
            now, "resume", job.job_id,
            f"restoring {workers}/{job.workers_before} workers "
            f"(suspended at t={job.suspended_at:.2f})",
            fast, slow,
        )
        return Regrant(job.job_id, workers, reason="budget recovered: resume")


class StaticAdmission:
    """The no-telemetry baseline: reject the newest arrival whenever the
    queue exceeds a fixed cap, always, overloaded or not.  Same decision
    interface and audit log as :class:`OverloadController` so the two sit
    symmetrically in benchmarks."""

    name = "static-admission"

    def __init__(self, queue_cap: int = 8):
        if queue_cap < 0:
            raise ValueError("queue_cap must be >= 0")
        self.queue_cap = int(queue_cap)
        self.log: list[ControlAction] = []

    def bind(self, cluster) -> None:
        del cluster

    def observe(self, record) -> None:
        del record

    def decide(self, queue, free_workers: int, now: float):
        del free_workers
        if len(queue) > self.queue_cap:
            victim = queue[-1]
            self.log.append(ControlAction(
                t=float(now), action="shed", job_id=victim.job_id,
                reason=f"queue {len(queue)} > static cap {self.queue_cap}",
                burn_fast=0.0, burn_slow=0.0,
            ))
            return Reject(victim, "shed by static admission cap")
        return None


class ControlledPolicy:
    """Wrap any scheduling policy with an admission controller.

    The controller speaks first at every ``select``/``idle`` event; only
    when it has nothing to say does the inner policy see the queue.
    Completions flow to both (controller first, so the burn windows are
    current before the inner policy's online refinement runs).
    """

    def __init__(self, inner, controller):
        self.inner = inner
        self.controller = controller
        self.name = f"{inner.name}+{controller.name}"

    def prepare(self, cluster, apps) -> None:
        self.controller.bind(cluster)
        self.inner.prepare(cluster, apps)

    def select(self, queue, free_workers: int, now: float):
        action = self.controller.decide(queue, free_workers, now)
        if action is not None:
            return action
        return self.inner.select(queue, free_workers, now)

    def idle(self, free_workers: int, now: float):
        action = self.controller.decide((), free_workers, now)
        if action is None or isinstance(action, Reject):
            inner_idle = getattr(self.inner, "idle", None)
            return None if inner_idle is None else inner_idle(
                free_workers, now
            )
        return action

    def observe(self, record) -> None:
        self.controller.observe(record)
        self.inner.observe(record)

    def observe_overhead(self, save_s: float, restore_s: float) -> None:
        hook = getattr(self.inner, "observe_overhead", None)
        if hook is not None:
            hook(save_s, restore_s)
