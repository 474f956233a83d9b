"""Job queue + cluster state: an event-driven multi-job simulator
(counterpart of ``repro.cluster.cluster``).

``Cluster`` owns W worker slots shared across concurrent jobs.  Time
advances event-to-event (job arrival / job completion); at every event the
active :mod:`scheduling policy <repro_torch.cluster.policies>` is offered the
queue of arrived-but-undispatched jobs and the free-worker count, and
answers with dispatch decisions (job + :class:`Plan`) or admission-control
rejections until nothing more fits.  A dispatched job's *true* runtime
comes from the :mod:`runtime oracle <repro_torch.cluster.oracle>`; the policy's
*predicted* runtime is recorded next to it, which is how every trace doubles
as an accuracy experiment (paper Fig. 3, per job instead of per config).

Invariants enforced here, not trusted to policies: a plan never exceeds
free workers, every job ends exactly once, worker accounting conserves, and
a policy that strands undispatchable jobs fails loudly instead of spinning.
"""

from __future__ import annotations

import dataclasses
import heapq
import math

from repro_torch.cluster.workload import JobSpec


@dataclasses.dataclass(frozen=True)
class Plan:
    """Dispatch decision for one job: execution config + worker grant."""

    backend: str
    mappers: int
    reducers: int
    workers: int                      # worker slots granted from the pool
    predicted_time: float | None = None  # policy's prediction, if it made one
    depth: int = 1                    # pipelined overlap depth (1 = serial)
    combiner: bool = False            # map-side combine stage on/off

    def __post_init__(self):
        if self.mappers < 1 or self.reducers < 1 or self.workers < 1:
            raise ValueError(f"bad plan {self}")
        if self.depth < 1:
            raise ValueError(f"bad plan {self}")


@dataclasses.dataclass(frozen=True)
class Dispatch:
    """Policy answer: run ``job`` now under ``plan``."""

    job: JobSpec
    plan: Plan


@dataclasses.dataclass(frozen=True)
class Reject:
    """Policy answer: admission control refuses ``job`` (e.g. its deadline
    is infeasible at every configuration)."""

    job: JobSpec
    reason: str


@dataclasses.dataclass
class JobRecord:
    """Full lifecycle accounting for one job."""

    spec: JobSpec
    plan: Plan | None = None
    admitted: bool = True
    reject_reason: str | None = None
    reject_time: float | None = None
    start: float | None = None
    finish: float | None = None
    true_time: float | None = None
    #: per-phase JobTrace from the oracle (when it supports take_trace),
    #: consumed by the online per-phase refit loop.
    trace: object | None = None
    #: elastic accounting (ElasticCluster): execution segments as
    #: [t_start, t_end, workers] triples (grant changes split segments;
    #: checkpoint/restore gaps between them hold workers but do no work),
    #: the number of regrants applied, and the total overhead paid.
    segments: list | None = None
    #: executed wave intervals [t0, t1, kind, workers] and non-executing
    #: holes [t0, t1, kind, workers_held] between segments (regrant /
    #: suspended), recorded by the elastic sim for the span exporter —
    #: together with ``segments`` they tile [start, finish] exactly.
    waves: list | None = None
    gaps: list | None = None
    n_regrants: int = 0
    n_suspends: int = 0
    overhead_s: float = 0.0
    #: seconds this job's shuffle was stretched by shared-fabric
    #: contention (0.0 on uncontended runs / capacity-unlimited clusters);
    #: audited in the trace as its own ``contention`` phase.
    contention_s: float = 0.0

    @property
    def completed(self) -> bool:
        return self.finish is not None

    @property
    def wait(self) -> float | None:
        return None if self.start is None else self.start - self.spec.arrival

    @property
    def turnaround(self) -> float | None:
        return None if self.finish is None else self.finish - self.spec.arrival

    @property
    def met_deadline(self) -> bool | None:
        """True/False for deadline jobs (rejected/unfinished = missed);
        None when the job has no deadline."""
        if self.spec.deadline is None:
            return None
        return self.completed and self.finish <= self.spec.deadline

    @property
    def prediction_error_pct(self) -> float | None:
        """|predicted - true| / true in percent (paper's error metric)."""
        if (
            self.plan is None
            or self.plan.predicted_time is None
            or self.true_time is None
        ):
            return None
        return abs(self.plan.predicted_time - self.true_time) / max(
            self.true_time, 1e-12
        ) * 100.0


@dataclasses.dataclass
class TraceResult:
    """One policy's run over one trace, plus derived summary metrics."""

    policy: str
    total_workers: int
    records: list[JobRecord]          # arrival order
    #: fabric capacity the run was priced against (None = unlimited) and
    #: the over-capacity episodes the shared fabric logged — carried on
    #: the result so the span/resource exporters need no extra plumbing.
    net_capacity: float | None = None
    contention_episodes: list = dataclasses.field(default_factory=list)

    def completed(self) -> list[JobRecord]:
        return [r for r in self.records if r.completed]

    def rejected(self) -> list[JobRecord]:
        return [r for r in self.records if not r.admitted]

    def prediction_errors(self) -> list[float]:
        """Per-job |pred-true|/true %, in completion order — the in-trace
        error trajectory the online-refinement loop is judged on."""
        done = sorted(self.completed(), key=lambda r: r.finish)
        return [
            e for r in done if (e := r.prediction_error_pct) is not None
        ]

    def metrics(self) -> dict:
        done = self.completed()
        if not done:
            raise RuntimeError(f"policy {self.policy!r} completed no jobs")
        t0 = min(r.spec.arrival for r in self.records)
        t_end = max(r.finish for r in done)
        makespan = t_end - t0
        # Elastic jobs carry per-segment grants; busy area sums actual
        # (duration x granted workers) per segment, excluding the
        # checkpoint/restore gaps (workers held but idle).
        busy_area = sum(
            sum((t1 - ts) * w for ts, t1, w in r.segments)
            if r.segments else r.true_time * r.plan.workers
            for r in done
        )
        deadline_jobs = [
            r for r in self.records if r.spec.deadline is not None
        ]
        errs = self.prediction_errors()
        half = len(errs) // 2
        mean = lambda xs: sum(xs) / len(xs) if xs else None  # noqa: E731
        return {
            "policy": self.policy,
            "n_jobs": len(self.records),
            "n_completed": len(done),
            "n_rejected": len(self.rejected()),
            "makespan_s": makespan,
            "mean_wait_s": mean([r.wait for r in done]),
            "mean_turnaround_s": mean([r.turnaround for r in done]),
            "utilization": busy_area / (self.total_workers * makespan),
            "slo_attainment": (
                mean([1.0 if r.met_deadline else 0.0 for r in deadline_jobs])
                if deadline_jobs else None
            ),
            "n_deadline_jobs": len(deadline_jobs),
            "pred_mae_pct": mean(errs),
            "pred_mae_pct_first_half": mean(errs[:half]),
            "pred_mae_pct_second_half": mean(errs[half:]),
            # Which overlap depths the policy actually dispatched (all 1s
            # for depth-unaware policies).
            "depth_histogram": {
                str(r.plan.depth): sum(
                    1 for q in done if q.plan.depth == r.plan.depth
                )
                for r in done
            },
            # Combiner-choice split (all "off" for combiner-unaware
            # policies) — how often the map-side combine axis paid off.
            "combiner_histogram": {
                ("on" if r.plan.combiner else "off"): sum(
                    1 for q in done if q.plan.combiner == r.plan.combiner
                )
                for r in done
            },
            # Elastic accounting (0 / 0.0 on inelastic runs).
            "n_regrants": sum(r.n_regrants for r in self.records),
            "n_preempted_jobs": sum(
                1 for r in self.records if r.n_regrants > 0
            ),
            "n_suspends": sum(r.n_suspends for r in self.records),
            "regrant_overhead_s": sum(r.overhead_s for r in self.records),
            # Shared-fabric contention accounting (zeros when the run had
            # no finite net_capacity).
            "contention_s_total": sum(
                r.contention_s for r in self.records
            ),
            "n_contended_jobs": sum(
                1 for r in self.records if r.contention_s > 0
            ),
            "n_contention_episodes": len(self.contention_episodes),
        }


class _JobSource:
    """Peekable, order-validated view over a (possibly unbounded) JobSpec
    iterator — the arrival side of the event loops.  Finite traces wrap a
    sorted list; service mode wraps an open-ended stream bounded by a
    horizon, and the loop materializes one arrival of lookahead at a
    time instead of the whole trace."""

    __slots__ = ("_it", "_next", "_seen", "_last_arrival")

    def __init__(self, jobs):
        self._it = iter(jobs)
        self._seen: set[int] = set()
        self._last_arrival = -math.inf
        self._next: JobSpec | None = None
        self._advance()

    def _advance(self) -> None:
        nxt = next(self._it, None)
        if nxt is not None:
            if nxt.job_id in self._seen:
                raise ValueError("duplicate job_id in trace")
            if nxt.arrival < self._last_arrival:
                raise ValueError(
                    f"job {nxt.job_id} arrives at {nxt.arrival:.6f}, "
                    "before its predecessor — streams must be time-ordered"
                )
            self._seen.add(nxt.job_id)
            self._last_arrival = nxt.arrival
        self._next = nxt

    def peek(self) -> JobSpec | None:
        return self._next

    def pop(self) -> JobSpec:
        job = self._next
        self._advance()
        return job


def _bounded(stream, until_time, until_jobs):
    """Cut an open-ended stream at the service horizon: stop *admitting*
    after ``until_jobs`` arrivals or the first arrival past
    ``until_time`` (whichever comes first); the sim then drains."""
    n = 0
    for job in stream:
        if until_jobs is not None and n >= until_jobs:
            return
        if until_time is not None and job.arrival > until_time:
            return
        n += 1
        yield job


class Cluster:
    """W worker slots + a runtime oracle; runs (trace, policy) -> result.

    With a finite ``net_capacity`` (bytes/s) concurrent jobs share one
    shuffle fabric: each dispatched job's shuffle transfer is priced on a
    :class:`repro_torch.cluster.oracle.SharedFabric`, and when aggregate demand
    exceeds capacity the job's shuffle stretches by the fair-share
    slowdown.  The stretch is added to the job's true time and audited in
    its trace as a ``contention`` phase, so phase walls still sum to the
    turnaround and span tiling closes.  This requires an oracle whose
    completed jobs carry per-phase traces with net counters
    (``prices_contention``); the constructor refuses the combination
    otherwise instead of silently skipping the charge.
    """

    def __init__(self, total_workers: int, oracle, *, metrics=None,
                 net_capacity: float | None = None):
        if total_workers < 1:
            raise ValueError("total_workers must be >= 1")
        self.total_workers = int(total_workers)
        self.oracle = oracle
        #: optional :class:`repro_torch.obs.metrics.ClusterMetrics` hook object;
        #: None (the default) keeps every event unobserved at the cost of
        #: one ``if`` per event.
        self.metrics = metrics
        self.net_capacity = (
            None if net_capacity is None or math.isinf(net_capacity)
            else float(net_capacity)
        )
        if self.net_capacity is not None:
            if not self.net_capacity > 0:
                raise ValueError(
                    f"net_capacity must be > 0, got {net_capacity!r}"
                )
            if not getattr(oracle, "prices_contention", False):
                platform = getattr(
                    oracle, "platform", type(oracle).__name__
                )
                raise ValueError(
                    f"net_capacity set, but oracle {platform!r} cannot "
                    "price contention: completed jobs carry no per-phase "
                    "net counters (use the analytic oracle or a traced "
                    "engine oracle)"
                )

    def run(self, jobs: list[JobSpec], policy) -> TraceResult:
        jobs = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
        if len({j.job_id for j in jobs}) != len(jobs):
            raise ValueError("duplicate job_id in trace")
        return self._run(jobs, policy, sorted({j.app for j in jobs}))

    def run_service(
        self,
        stream,
        policy,
        *,
        until_time: float | None = None,
        until_jobs: int | None = None,
        apps: list[str] | None = None,
        health_every: float | None = None,
        on_health=None,
    ) -> TraceResult:
        """Serve an open-ended arrival stream up to a horizon, then drain.

        ``stream`` is any time-ordered iterable of :class:`JobSpec`
        (see :mod:`repro_torch.cluster.streams`); arrivals stop at
        ``until_time`` sim seconds and/or after ``until_jobs`` arrivals —
        at least one bound is required — and jobs already admitted run to
        completion.  Jobs are materialized incrementally (one of
        lookahead), so memory tracks the *live* set, not the horizon.
        ``apps`` defaults to the stream's ``apps`` attribute (needed for
        ``policy.prepare`` before any job exists).  Every
        ``health_every`` sim seconds ``on_health(now, snapshot)`` fires
        with queue/worker/suspension gauges — the CLI's periodic health
        table and the natural place to read windowed SLO metrics.
        """
        if until_time is None and until_jobs is None:
            raise ValueError(
                "run_service needs until_time and/or until_jobs — an "
                "unbounded service never returns"
            )
        if apps is None:
            apps = list(getattr(stream, "apps", ()) or ())
        if not apps:
            raise ValueError(
                "run_service needs the app universe up front: pass "
                "apps=[...] or use a stream with an .apps attribute"
            )
        if health_every is not None and health_every <= 0:
            raise ValueError("health_every must be > 0")
        return self._run(
            _bounded(stream, until_time, until_jobs), policy, sorted(apps),
            health_every=health_every, on_health=on_health,
        )

    def _health_snapshot(
        self, now: float, pending, free: int, suspended: int = 0
    ) -> dict:
        snap = {
            "t": now,
            "queue_depth": len(pending),
            "busy_workers": self.total_workers - free,
            "free_workers": free,
            "suspended_jobs": suspended,
        }
        if self.metrics is not None:
            windowed = self.metrics.windowed_summary(now)
            if windowed is not None:
                snap["windowed"] = windowed
        return snap

    def _run(
        self, jobs, policy, apps, *, health_every=None, on_health=None
    ) -> TraceResult:
        source = _JobSource(jobs)
        records: dict[int, JobRecord] = {}
        order: list[int] = []         # job_ids in arrival order
        fabric = None
        if self.net_capacity is not None:
            from repro_torch.cluster.oracle import SharedFabric

            # Per-run state: one run's transfers must not price another's.
            fabric = SharedFabric(self.net_capacity)
        policy.prepare(self, apps)

        pending: list[JobSpec] = []   # arrived, not yet dispatched (FIFO order)
        running: list[tuple[float, int, int]] = []  # (finish, seq, job_id)
        free = self.total_workers
        seq = 0     # heap tiebreak
        first = source.peek()
        now = first.arrival if first is not None else 0.0
        next_health = (
            now + health_every if health_every is not None else None
        )
        metrics = self.metrics
        if metrics is not None:
            metrics.on_run_start(now)

        while source.peek() is not None or pending or running:
            nxt = source.peek()
            next_arrival = nxt.arrival if nxt is not None else math.inf
            next_finish = running[0][0] if running else math.inf
            if pending and not running and next_arrival == math.inf:
                # Nothing can ever free workers or arrive: the policy has
                # stranded jobs it will never dispatch.
                stuck = [j.job_id for j in pending]
                raise RuntimeError(
                    f"policy {policy.name!r} stranded jobs {stuck}: no "
                    f"dispatch at free={free}/{self.total_workers} workers"
                )
            now = min(next_arrival, next_finish)

            while (nxt := source.peek()) is not None and nxt.arrival <= now:
                job = source.pop()
                records[job.job_id] = JobRecord(spec=job)
                order.append(job.job_id)
                pending.append(job)
                if metrics is not None:
                    metrics.on_arrival(job.arrival, job)
            while running and running[0][0] <= now:
                _, _, done_id = heapq.heappop(running)
                rec = records[done_id]
                rec.finish = rec.start + rec.true_time
                free += rec.plan.workers
                if metrics is not None:
                    metrics.on_finish(rec.finish, rec)
                policy.observe(rec)

            while pending:
                decision = policy.select(tuple(pending), free, now)
                if decision is None:
                    break
                if isinstance(decision, Reject):
                    rec = records[decision.job.job_id]
                    rec.admitted = False
                    rec.reject_reason = decision.reason
                    rec.reject_time = now
                    pending.remove(decision.job)
                    if metrics is not None:
                        metrics.on_reject(now, rec)
                    continue
                if not isinstance(decision, Dispatch):
                    raise TypeError(
                        f"policy returned {type(decision).__name__}; "
                        "expected Dispatch, Reject, or None"
                    )
                job, plan = decision.job, decision.plan
                if job not in pending:
                    raise ValueError(
                        f"policy dispatched job {job.job_id} not in queue"
                    )
                if plan.workers > free:
                    raise ValueError(
                        f"plan for job {job.job_id} wants {plan.workers} "
                        f"workers but only {free} are free"
                    )
                pending.remove(job)
                rec = records[job.job_id]
                rec.plan = plan
                rec.start = now
                # Off-default knobs stay out of the call so knob-unaware
                # oracle stand-ins (tests, stubs) keep narrow signatures.
                extra = {"depth": plan.depth} if plan.depth != 1 else {}
                if plan.combiner:
                    extra["combiner"] = True
                rec.true_time = self.oracle.time(
                    job.app, plan.backend, job.size,
                    plan.mappers, plan.reducers, plan.workers,
                    job_id=job.job_id, **extra,
                )
                take_trace = getattr(self.oracle, "take_trace", None)
                if take_trace is not None:
                    rec.trace = take_trace()
                if fabric is not None:
                    _charge_contention(fabric, rec, now)
                free -= plan.workers
                seq += 1
                heapq.heappush(running, (now + rec.true_time, seq, job.job_id))
                if metrics is not None:
                    metrics.on_dispatch(now, rec)
            if fabric is not None:
                fabric.prune(now)
            if metrics is not None:
                metrics.sample(
                    now, len(pending), self.total_workers - free, 0,
                    net_bytes_per_s=(
                        fabric.demand_at(now) if fabric is not None
                        else None
                    ),
                    net_capacity=self.net_capacity,
                )
            if next_health is not None and now >= next_health:
                if on_health is not None:
                    on_health(
                        now, self._health_snapshot(now, pending, free)
                    )
                while next_health <= now:
                    next_health += health_every

        assert free == self.total_workers, "worker accounting leaked"
        return TraceResult(
            policy=policy.name,
            total_workers=self.total_workers,
            records=[records[job_id] for job_id in order],
            net_capacity=self.net_capacity,
            contention_episodes=(
                list(fabric.episodes) if fabric is not None else []
            ),
        )


def _charge_contention(fabric, rec: JobRecord, now: float) -> float:
    """Price ``rec``'s shuffle transfer on the shared fabric at dispatch.

    The transfer window opens after the phases recorded ahead of the
    shuffle entry (the map phase) and nominally lasts the shuffle wall.
    Any fair-share stretch is added to the job's true time and audited as
    a ``contention`` phase right after the shuffle — walls still sum to
    the turnaround, so conservation and span tiling keep closing.  Jobs
    without a usable trace (no shuffle entry, zero net bytes) simply
    don't occupy the fabric.
    """
    trace = rec.trace
    if trace is None or "shuffle" not in trace.phase_names():
        return 0.0
    sh = trace.phase("shuffle")
    nbytes = sh.counters.get(
        "net_bytes", sh.counters.get("bytes_in", 0.0)
    )
    if nbytes <= 0 or sh.wall_s <= 0:
        return 0.0
    pre = 0.0
    for p in trace.phases:
        if p.phase == "shuffle":
            break
        pre += max(0.0, p.wall_s)
    stretch = fabric.admit(
        rec.spec.job_id, now + pre, sh.wall_s, nbytes
    )
    if stretch <= 0.0:
        return 0.0
    # Audited stall: no fabric bytes of its own, no CPU burned — the job
    # is waiting on its fair share of the wire.
    trace.record_phase(
        "contention", stretch,
        net_bytes=0.0, cpu_s=0.0, cpu_workers=1.0,
        fabric_capacity=fabric.capacity,
    )
    trace.phases.insert(
        trace.phases.index(sh) + 1, trace.phases.pop()
    )
    if trace.total_s is not None:
        trace.finish(trace.total_s + stretch)
    rec.contention_s = stretch
    rec.true_time += stretch
    return stretch
