"""Scheduling policies: where a prediction becomes a decision
(counterpart of ``repro.cluster.policies``).

Every policy answers one question at every scheduling event: *given the
queue of arrived jobs and the free workers, what runs next and under which
configuration?*  The baseline answers it the way the paper's motivation
section says real clusters do — first-come-first-served with a static
config.  The prediction-driven policies close the paper's loop instead:

* bootstrap: :func:`repro_torch.core.tuner.tune_categorical` profiles the runtime
  oracle per (application, backend) over a (M, R, W-share, size) space and
  publishes the per-backend fitted models into a shared
  :class:`~repro_torch.core.predictor.ModelDatabase` (paper Fig. 2a+2b, one slot
  per category);
* per job: the stored models are evaluated over the configuration grid at
  the job's size and the joint (backend, M, R, W) argmin becomes the
  dispatch :class:`~repro_torch.cluster.cluster.Plan`, with its predicted time
  attached — prediction before dispatch, the paper's "smarter scheduler";
* online: every completion flows through
  :class:`~repro_torch.cluster.online.OnlineRefiner`, so the models sharpen as
  the cluster runs.

Policies register by name (same idiom as the MapReduce backend
registries): ``@register_policy`` + ``get_policy(name, **kwargs)``.
"""

from __future__ import annotations

import itertools
import math

import numpy as np

from repro_torch.cluster.cluster import Dispatch, Plan, Reject
from repro_torch.cluster.online import (
    DEFAULT_FIT_KWARGS,
    FIT_DEVICE,
    OnlineRefiner,
)
from repro_torch.cluster.oracle import PROFILE_JOB_ID
from repro_torch.cluster.workload import JobSpec
from repro_torch.core.predictor import ModelDatabase
from repro_torch.core.regression import RegressionModel, fit as regression_fit
from repro_torch.core.tuner import tune_categorical

#: size feature is in kilotokens: same order of magnitude as M/R/W, which
#: keeps the scaled polynomial basis well-conditioned.
SIZE_UNIT = 1024.0


def _cat_key(backend: str, depth: int = 1, combiner: bool = False) -> str:
    """Category key for the (backend, overlap_depth, combiner) model slot.

    Depth and the combiner join the model database the same way the
    backend did: as *categorical* axes — one polynomial model per
    category value (the paper's numeric basis can't embed them; see
    ``tune_categorical``).  Depth 1 keys as the bare backend and the
    combiner-off key carries no suffix, so existing on-disk databases
    and every depth/combiner-unaware policy keep their exact legacy
    keys; combiner-on appends ``+c`` (``"scatter_reduce@d2+c"``,
    ``"torch+c"``)."""
    d = int(depth)
    key = backend if d == 1 else f"{backend}@d{d}"
    return f"{key}+c" if combiner else key


def _parse_cat(key: str) -> tuple[str, int, bool]:
    """Inverse of :func:`_cat_key`:
    ``"scatter_reduce@d2+c" -> ("scatter_reduce", 2, True)``."""
    combiner = key.endswith("+c")
    if combiner:
        key = key[:-2]
    backend, _, d = key.partition("@d")
    return backend, int(d) if d else 1, combiner


def _np_design(spec, rows: np.ndarray) -> np.ndarray:
    """Numpy twin of ``features.design_matrix`` for hot scheduler loops.

    The torch version pays device-dispatch latency per call; the scheduler
    evaluates tiny (≤ a few hundred rows) grids thousands of times per
    trace, where numpy is orders of magnitude faster.  Kept in lockstep
    with ``FeatureSpec`` by ``tests/test_torch_cluster.py``.
    """
    p = np.asarray(rows, dtype=np.float64)
    if p.ndim == 1:
        p = p[None, :]
    if spec.scale:
        lo = np.asarray(spec.lo)
        hi = np.asarray(spec.hi)
        p = (p - lo) / (hi - lo)
    cols = [np.ones((p.shape[0], 1))]
    for i in range(spec.n_params):
        pi = p[:, i:i + 1]
        acc = pi
        for _ in range(spec.degree):
            cols.append(acc)
            acc = acc * pi
    if spec.cross_terms:
        for i in range(spec.n_params):
            for j in range(i + 1, spec.n_params):
                cols.append(p[:, i:i + 1] * p[:, j:j + 1])
    return np.concatenate(cols, axis=1)


def _np_predict(model: RegressionModel, rows: np.ndarray) -> np.ndarray:
    return _np_design(model.spec, rows) @ np.asarray(
        model.coef, dtype=np.float64
    )


class SchedulingPolicy:
    """Interface the :class:`~repro_torch.cluster.cluster.Cluster` drives."""

    name: str = "abstract"

    def prepare(self, cluster, apps: list[str]) -> None:
        """Called once before the trace with the cluster and its app set."""

    def select(self, queue: tuple[JobSpec, ...], free_workers: int, now: float):
        """Return Dispatch/Reject/None for the current queue state."""
        raise NotImplementedError

    def observe(self, record) -> None:
        """Called on every job completion (online-refinement hook)."""


POLICIES: dict[str, type[SchedulingPolicy]] = {}


def register_policy(cls: type[SchedulingPolicy]) -> type[SchedulingPolicy]:
    if not cls.name or cls.name == "abstract":
        raise ValueError(f"policy {cls.__name__} needs a concrete name")
    POLICIES[cls.name] = cls
    return cls


def get_policy(name: str, **kwargs) -> SchedulingPolicy:
    if name not in POLICIES:
        raise KeyError(
            f"unknown policy {name!r}; registered: {sorted(POLICIES)}"
        )
    return POLICIES[name](**kwargs)


@register_policy
class StaticFIFO(SchedulingPolicy):
    """Baseline: first-come-first-served, one static config for every job.

    The static (M, R) defaults sit mid-range of the paper's [5, 40] sweep —
    a "reasonable operator default", which is precisely what the paper
    argues against.  Head-of-line blocking included, as in a plain FIFO
    submit queue."""

    name = "fifo-static"

    def __init__(self, *, mappers: int = 20, reducers: int = 20,
                 workers: int = 4, backend: str = "torch"):
        self._plan = Plan(
            backend=backend, mappers=mappers, reducers=reducers,
            workers=workers,
        )

    def prepare(self, cluster, apps):
        if self._plan.workers > cluster.total_workers:
            raise ValueError(
                f"static worker grant {self._plan.workers} exceeds cluster "
                f"size {cluster.total_workers}"
            )

    def select(self, queue, free_workers, now):
        if self._plan.workers > free_workers:
            return None  # head-of-line blocking: FIFO never reorders
        return Dispatch(queue[0], self._plan)


class PredictivePolicy(SchedulingPolicy):
    """Shared machinery for prediction-driven policies.

    Owns the ModelDatabase, the bootstrap profiling pass (via
    ``tune_categorical``), per-job plan selection from the stored models,
    and the online-refinement hookup.  Subclasses only choose *which* job
    goes next.
    """

    def __init__(
        self,
        *,
        db: ModelDatabase | None = None,
        backends: tuple[str, ...] | None = None,
        mapper_grid: tuple[int, ...] = (4, 8, 16, 24, 32),
        reducer_grid: tuple[int, ...] = (4, 8, 16, 24, 32),
        worker_grid: tuple[int, ...] = (2, 4, 8),
        bootstrap_sizes: tuple[int, ...] = (1 << 14, 1 << 16, 1 << 18),
        n_bootstrap: int | None = None,
        bootstrap_repeats: int = 1,
        online: bool = True,
        refit_every: int = 1,
        seed: int = 0,
        fit_kwargs: dict | None = None,
        depth_grid: tuple[int, ...] = (1,),
        combiner_grid: tuple[bool, ...] = (False,),
        ledger=None,
    ):
        self.db = db if db is not None else ModelDatabase()
        self._backends_arg = backends
        self.mapper_grid = tuple(mapper_grid)
        self.reducer_grid = tuple(reducer_grid)
        self.worker_grid = tuple(sorted(worker_grid))
        self.depth_grid = tuple(sorted(set(int(d) for d in depth_grid)))
        if not self.depth_grid or self.depth_grid[0] < 1:
            raise ValueError(f"bad depth_grid {depth_grid!r}")
        #: combiner axis: (False,) = legacy off-only; (False, True) lets
        #: the policy profile and choose map-side combining per job.
        self.combiner_grid = tuple(
            dict.fromkeys(bool(c) for c in combiner_grid)
        )
        if not self.combiner_grid:
            raise ValueError(f"bad combiner_grid {combiner_grid!r}")
        self.bootstrap_sizes = tuple(bootstrap_sizes)
        self.n_bootstrap = n_bootstrap
        self.bootstrap_repeats = bootstrap_repeats
        self.online = online
        self.refit_every = refit_every
        self.seed = seed
        self.fit_kwargs = dict(fit_kwargs or DEFAULT_FIT_KWARGS)
        self.refiner: OnlineRefiner | None = None
        #: optional :class:`repro_torch.obs.drift.PredictionLedger`: every
        #: completion's (predicted, realized) pair is recorded per
        #: category, and a drift alarm triggers a category-targeted
        #: ``refit_category`` instead of trusting the every-completion
        #: refit to dig the model out from under its stale seed anchors.
        self.ledger = ledger
        self.n_drift_alarms = 0
        self._model_version = 0
        self._plan_cache: dict = {}
        # Drift-refit epoch, bumped per alarm-triggered refit.  Jobs in
        # flight when a correction lands still carry pre-correction
        # predictions; the ledger must not see those completions or every
        # one re-alarms and the corrections compound (a 1.5x rescale
        # applied N times).  Each plan stamps the epoch it was made under.
        self._drift_epoch = 0
        self._plan_drift_epoch: dict[int, int] = {}

    # ---- bootstrap profiling (paper Fig. 2a + 2b) -----------------------

    def prepare(self, cluster, apps):
        self.cluster = cluster
        oracle = cluster.oracle
        self.platform = oracle.platform
        self.backends = tuple(self._backends_arg or oracle.backends())
        #: one model category per (backend, overlap_depth, combiner) —
        #: depth and the combiner are categorical axes exactly like the
        #: backend, so the numeric feature rows (M, R, W, size) and the
        #: wire format of every stored model are unchanged.
        self.categories = tuple(
            _cat_key(b, d, c)
            for b, d, c in itertools.product(
                self.backends, self.depth_grid, self.combiner_grid
            )
        )
        self.worker_grid = tuple(
            w for w in self.worker_grid if w <= cluster.total_workers
        ) or (cluster.total_workers,)
        self.refiner = OnlineRefiner(
            self.db, self.platform,
            refit_every=self.refit_every, fit_kwargs=self.fit_kwargs,
        )
        space = np.asarray(
            [
                (m, r, w, s / SIZE_UNIT)
                for m, r, w, s in itertools.product(
                    self.mapper_grid, self.reducer_grid, self.worker_grid,
                    self.bootstrap_sizes,
                )
            ],
            dtype=np.float64,
        )
        profile_seq = itertools.count()  # distinct noise draw per profile run
        for app in apps:
            if all(
                (app, self.platform, c) in self.db for c in self.categories
            ):
                continue  # warm start: models reloaded from disk

            def make_run_fn(app_name, backend_name, depth, combiner):
                # Off-default knobs stay out of the call signature so
                # narrow oracle stubs (and legacy oracles) keep working.
                extra = {} if depth == 1 else {"depth": depth}
                if combiner:
                    extra["combiner"] = True

                def run(row):
                    return oracle.time(
                        app_name, backend_name, int(row[3] * SIZE_UNIT),
                        int(row[0]), int(row[1]), int(row[2]),
                        job_id=PROFILE_JOB_ID + next(profile_seq),
                        **extra,
                    )
                return run

            result = tune_categorical(
                {
                    _cat_key(b, d, c): make_run_fn(app, b, d, c)
                    for b, d, c in itertools.product(
                        self.backends, self.depth_grid, self.combiner_grid
                    )
                },
                space,
                n_samples=self.n_bootstrap,
                repeats=self.bootstrap_repeats,
                seed=self.seed,
                device=FIT_DEVICE,
                **self.fit_kwargs,
            )
            for cat, tr in result.per_category.items():
                self.db.put(app, self.platform, tr.model, backend=cat)
                self.refiner.seed_profiles(
                    app, cat, tr.sampled_configs, tr.sampled_times
                )

    # ---- per-job planning (paper Fig. 2b: predict before dispatch) ------

    def _w_bucket(self, free_workers: int) -> int | None:
        """Largest grant in the worker grid that fits the free pool."""
        fitting = [w for w in self.worker_grid if w <= free_workers]
        return max(fitting) if fitting else None

    def best_plan(self, job: JobSpec, free_workers: int) -> Plan | None:
        """Joint (backend, M, R, W) argmin of predicted time at this job's
        size, over grants that fit ``free_workers``.  None = nothing fits."""
        bucket = self._w_bucket(free_workers)
        if bucket is None:
            return None
        key = (job.job_id, bucket, self._model_version)
        if key not in self._plan_cache:
            self._plan_cache[key] = self._argmin_plan(
                job, [w for w in self.worker_grid if w <= bucket]
            )
        self._plan_drift_epoch[job.job_id] = self._drift_epoch
        return self._plan_cache[key]

    def _candidate_rows(self, job: JobSpec, w_options) -> np.ndarray:
        return np.asarray(
            [
                (m, r, w, job.size / SIZE_UNIT)
                for m, r, w in itertools.product(
                    self.mapper_grid, self.reducer_grid, w_options
                )
            ],
            dtype=np.float64,
        )

    def _predict_grid(
        self, job: JobSpec, w_options
    ) -> tuple[np.ndarray, dict[str, np.ndarray]]:
        rows = self._candidate_rows(job, w_options)
        preds = {}
        for cat in self.categories:
            model = self.db.get(job.app, self.platform, backend=cat)
            # A polynomial happily predicts <= 0 outside its training mass;
            # floor it so rankings and deadline math stay sane.
            preds[cat] = np.maximum(_np_predict(model, rows), 1e-3)
        return rows, preds

    def _argmin_plan(self, job: JobSpec, w_options) -> Plan:
        rows, preds = self._predict_grid(job, w_options)
        best = None
        for cat, pred in preds.items():
            i = int(np.argmin(pred))
            if best is None or pred[i] < best[0]:
                best = (float(pred[i]), cat, rows[i])
        t, cat, row = best
        backend, depth, combiner = _parse_cat(cat)
        return Plan(
            backend=backend, mappers=int(row[0]), reducers=int(row[1]),
            workers=int(row[2]), predicted_time=t, depth=depth,
            combiner=combiner,
        )

    # ---- online refinement ----------------------------------------------

    def observe(self, record):
        if not self.online or record.plan is None:
            return
        plan, spec = record.plan, record.spec
        row = (plan.mappers, plan.reducers, plan.workers,
               spec.size / SIZE_UNIT)
        cat = _cat_key(plan.backend, getattr(plan, "depth", 1),
                       getattr(plan, "combiner", False))
        refitted = self.refiner.observe(
            spec.app, cat, row, record.true_time
        )
        if (
            self.ledger is not None
            and plan.predicted_time is not None
            and self._plan_drift_epoch.get(
                spec.job_id, self._drift_epoch
            ) == self._drift_epoch
        ):
            alarm = self.ledger.record(
                spec.app, cat, plan.predicted_time, record.true_time,
                t=record.finish,
            )
            if alarm is not None:
                self.n_drift_alarms += 1
                self._drift_epoch += 1
                refitted = self.refiner.refit_category(
                    spec.app, cat,
                    keep_last=self.ledger.keep_last,
                    scale_hint=alarm.scale_hint,
                ) or refitted
        if refitted:
            self._model_version += 1
            self._plan_cache.clear()
        # Oracles that return per-phase traces (telemetry layer) feed the
        # decomposed models too; phase models don't drive plan selection,
        # so no cache invalidation is needed.
        if record.trace is not None:
            self.refiner.observe_phases(
                spec.app, cat, row, record.trace.phase_times()
            )


@register_policy
class PredictiveFIFO(PredictivePolicy):
    """FIFO order, but each job runs at its model-chosen configuration.

    Isolates the value of per-job configuration tuning from the value of
    reordering (compare against ``predict-sjf`` on the same trace)."""

    name = "predict-fifo"

    def select(self, queue, free_workers, now):
        plan = self.best_plan(queue[0], free_workers)
        if plan is None:
            return None
        return Dispatch(queue[0], plan)


@register_policy
class PredictedSJF(PredictivePolicy):
    """Shortest-predicted-job-first with backfilling.

    Among queued jobs whose best plan fits the free pool, dispatch the one
    with the smallest predicted completion time — the classic SJF
    wait-time win, made possible *only* by the config→time model (true
    service times are unknown before execution)."""

    name = "predict-sjf"

    def select(self, queue, free_workers, now):
        best = None
        for job in queue:
            plan = self.best_plan(job, free_workers)
            if plan is None:
                continue
            if best is None or plan.predicted_time < best[1].predicted_time:
                best = (job, plan)
        return Dispatch(*best) if best else None


@register_policy
class PipelinedSJF(PredictedSJF):
    """``predict-sjf`` with the overlap-depth axis switched on.

    Profiles every (backend, depth) category during bootstrap (depth
    rides :func:`tune_categorical` exactly like the backend does), so
    per job the joint (backend, M, R, W, depth) argmin decides whether —
    and how deep — the engine's software-pipelined mode pays off.
    Against an oracle whose depth axis is flat this degenerates to
    ``predict-sjf`` with extra profiling; against the pipelined-aware
    oracles the chosen depth is an interior, size-dependent optimum —
    the paper's configuration-dependency thesis on a brand-new axis.

    Requires an oracle whose ``time`` accepts ``depth=`` for every value
    in ``depth_grid`` beyond 1 (AnalyticOracle always does;
    EngineOracle needs ``pipelined=True``)."""

    name = "predict-pipeline"

    def __init__(self, **kwargs):
        kwargs.setdefault("depth_grid", (1, 2, 4))
        super().__init__(**kwargs)


@register_policy
class CombinerSJF(PredictedSJF):
    """``predict-sjf`` with the map-side-combiner axis switched on.

    Profiles every (backend, combiner) category during bootstrap (the
    ``+c`` categories ride :func:`tune_categorical` exactly like the
    backend), so per job the joint (backend, M, R, W, combiner) argmin
    decides whether pre-aggregating map output — paying combine compute
    for contracted shuffle bytes — beats shipping the raw stream.  The
    tradeoff is size- and key-space-dependent (big skewed jobs combine,
    small or high-cardinality ones don't), which is the paper's
    configuration-dependency thesis on the combiner axis.

    Requires an oracle whose ``time`` accepts ``combiner=`` (both
    bundled oracles do)."""

    name = "predict-combine"

    def __init__(self, **kwargs):
        kwargs.setdefault("combiner_grid", (False, True))
        super().__init__(**kwargs)


@register_policy
class DeadlineAware(PredictivePolicy):
    """Earliest-deadline-first + model-based admission control.

    A job whose deadline cannot be met even at the fastest predicted
    configuration (max worker grant, best backend) is rejected up front —
    capacity is never burned on a lost cause.  Admission is *queue-aware*:
    before declaring a deadline infeasible, the estimated queue wait (the
    predicted service times of jobs ahead in dispatch order, scaled by
    their share of the worker pool) is added to the job's own predicted
    service time — a job that is feasible at dispatch but queued behind
    enough work is a lost cause too (ROADMAP "smarter admission").
    Feasible deadline jobs are served EDF with the *cheapest* grant that
    still meets the deadline (predicted), leaving workers for the rest;
    best-effort jobs (no deadline) backfill last at their fastest plan."""

    name = "predict-deadline"

    def __init__(self, *, slo_margin: float = 0.0,
                 queue_aware: bool = True, **kwargs):
        super().__init__(**kwargs)
        self.slo_margin = slo_margin  # fractional safety margin on deadlines
        self.queue_aware = queue_aware

    def _deadline_budget(self, job: JobSpec, now: float) -> float:
        return (job.deadline - now) / (1.0 + self.slo_margin)

    def _queue_share(self, plan: Plan | None) -> float:
        """Estimated pool-time one queued job consumes before those behind
        it can expect workers: predicted service time weighted by its share
        of the pool (W jobs at grant w each overlap ~ total/w ways)."""
        if plan is None or plan.predicted_time is None:
            return 0.0
        return plan.predicted_time * (
            plan.workers / self.cluster.total_workers
        )

    def _cheapest_feasible(
        self, job: JobSpec, free_workers: int, budget: float
    ) -> Plan | None:
        """Min-grant (then min-time) plan predicted to finish in budget."""
        w_options = [w for w in self.worker_grid if w <= free_workers]
        if not w_options:
            return None
        rows, preds = self._predict_grid(job, w_options)
        best = None
        for cat, pred in preds.items():
            ok = np.nonzero(pred <= budget)[0]
            for i in ok:
                cand = (int(rows[i][2]), float(pred[i]), cat, rows[i])
                if best is None or cand[:2] < best[:2]:
                    best = cand
        if best is None:
            return None
        _, t, cat, row = best
        backend, depth, combiner = _parse_cat(cat)
        return Plan(
            backend=backend, mappers=int(row[0]), reducers=int(row[1]),
            workers=int(row[2]), predicted_time=t, depth=depth,
            combiner=combiner,
        )

    def _admission_sweep(self, order, free_workers, now):
        """Queue-aware admission: walk the dispatch order accumulating the
        estimated queue wait; return a Reject for the first deadline job
        whose own fastest service time plus that wait overruns its budget.

        The dispatch loop below alone cannot do this — it returns at the
        first dispatch/hold, so jobs queued behind others would only be
        re-examined (and rejected) after their budget had silently burned
        down.  The sweep rejects them up front instead.

        Parallelism-aware: a virtual free-worker pool (seeded with the
        currently free workers) is drained by the grants of jobs ahead;
        a job that still fits the pool runs *concurrently* with the queue
        ahead and experiences no queue wait.  Only once the pool is
        exhausted do the accumulated pool-shares of the jobs ahead count
        as estimated wait.
        """
        wait_ahead = 0.0    # pool-share of everything ahead (worker-time)
        virtual_free = free_workers
        for job in order:
            fastest = self.best_plan(job, self.cluster.total_workers)
            grant = fastest.workers if fastest is not None else 0
            fits_now = 0 < grant <= virtual_free
            if job.deadline is not None:
                budget = self._deadline_budget(job, now)
                t_fast = (
                    fastest.predicted_time if fastest is not None
                    else float("inf")
                )
                queue_wait = 0.0 if fits_now else wait_ahead
                if t_fast + queue_wait > budget:
                    return Reject(
                        job,
                        f"infeasible: fastest predicted {t_fast:.3f}s"
                        + (
                            f" + est. queue wait {queue_wait:.3f}s"
                            if queue_wait > 0 else ""
                        )
                        + f" > budget {budget:.3f}s",
                    )
            if fits_now:
                virtual_free -= grant
            wait_ahead += self._queue_share(fastest)
        return None

    def select(self, queue, free_workers, now):
        order = sorted(
            queue,
            key=lambda j: (
                j.deadline if j.deadline is not None else float("inf"),
                j.arrival, j.job_id,
            ),
        )
        if self.queue_aware:
            reject = self._admission_sweep(order, free_workers, now)
            if reject is not None:
                return reject
        for job in order:
            if job.deadline is None:
                plan = self.best_plan(job, free_workers)
                if plan is not None:
                    return Dispatch(job, plan)
                continue
            budget = self._deadline_budget(job, now)
            fastest = self.best_plan(job, self.cluster.total_workers)
            if fastest is None or fastest.predicted_time > budget:
                return Reject(
                    job,
                    f"infeasible: fastest predicted "
                    f"{fastest.predicted_time if fastest else float('inf'):.3f}s"
                    f" > budget {budget:.3f}s",
                )
            plan = self._cheapest_feasible(job, free_workers, budget)
            if plan is not None:
                return Dispatch(job, plan)
            # Feasible with a bigger grant than is currently free: hold the
            # workers we have (EDF reservation) rather than backfilling
            # past an urgent job.
            return None
        return None


def _pre_shuffle_wall(times: dict) -> float:
    """Wall seconds before the shuffle opens (trace phase order)."""
    pre = 0.0
    for phase, t in times.items():
        if phase == "shuffle":
            break
        if t > 0:
            pre += t
    return pre


@register_policy
class ResourceAware(PredictedSJF):
    """SJF scheduling against predicted fabric demand (telemetry-driven).

    Beyond the total-time model, this policy fits three fabric models per
    (application, backend) from the oracle's per-phase profiles
    (``phase_profile``, backed by the telemetry layer's decomposed
    counters): shuffle *bytes*, the wall time *before* the shuffle opens,
    and the shuffle *wall* itself.  Together they predict each dispatch's
    fabric transfer as a time window ``[t0, t1) @ bytes/s`` — the same
    shape the contention-aware ground truth (:class:`repro_torch.cluster.oracle.
    SharedFabric`) prices.  A candidate is scored by its predicted time
    plus ``contention_alpha`` x the fair-share stretch its window would
    suffer against the windows of already-running jobs (intervals where
    aggregate demand D exceeds ``net_capacity`` C inflate by D/C),
    steering dispatch away from co-scheduling overlapping shuffle-heavy
    transfers — what a network-provisioning model (arXiv:1206.2016) says
    to avoid.

    ``net_capacity=None`` (default) means an unconstrained fabric: scoring
    reduces exactly to predicted time and the policy is decision-for-
    decision identical to ``predict-sjf`` — the safe default for oracles
    that do not model network contention.  Operators set it to their
    fabric's sustained bytes/s.  The policy is work-conserving either
    way: contention re-orders dispatch, it never idles workers.
    """

    name = "predict-resource"

    def __init__(self, *, net_capacity: float | None = None,
                 contention_alpha: float = 4.0, **kwargs):
        super().__init__(**kwargs)
        self.net_capacity = (
            float("inf") if net_capacity is None else float(net_capacity)
        )
        if self.net_capacity <= 0:
            raise ValueError("net_capacity must be positive")
        self.contention_alpha = float(contention_alpha)
        self._bytes_models: dict[tuple[str, str], RegressionModel] = {}
        self._window_models: dict[tuple[str, str], tuple] = {}
        #: job_id -> (t0, t1, bytes/s): predicted fabric windows of
        #: currently running jobs.
        self._windows: dict[int, tuple[float, float, float]] = {}
        self.n_contention_deferrals = 0

    # ---- bootstrap: fit fabric models from phase profiles ---------------

    def prepare(self, cluster, apps):
        super().prepare(cluster, apps)
        self._windows.clear()
        profile = getattr(cluster.oracle, "phase_profile", None)
        if profile is None:
            return  # no per-phase source: behave as plain predict-sjf
        from repro_torch.telemetry.models import phase_resource_key

        res_keys = {
            "bytes": phase_resource_key("shuffle", "bytes"),
            "pre": phase_resource_key("shuffle", "window_pre_s"),
            "wall": phase_resource_key("shuffle", "window_wall_s"),
        }
        # A compact profiling set suffices: shuffle bytes are ~linear in
        # size and barely config-dependent, but we keep the full feature
        # row so the stored models compose with everything else.
        rows = np.asarray(
            [
                (m, r, self.worker_grid[-1], s / SIZE_UNIT)
                for m, r, s in itertools.product(
                    self.mapper_grid[:: max(1, len(self.mapper_grid) - 1)],
                    self.reducer_grid[:: max(1, len(self.reducer_grid) - 1)],
                    self.bootstrap_sizes,
                )
            ],
            dtype=np.float64,
        )
        for app in apps:
            for backend, comb in itertools.product(
                self.backends, self.combiner_grid
            ):
                # Fabric models are per (app, backend, combiner): the
                # combined stream ships fewer bytes over a different
                # window, and the whole point of the axis is that the
                # scheduler can *predict* that contraction.  Combiner-off
                # keeps the bare-backend key (legacy databases load).
                cat = _cat_key(backend, 1, comb)
                extra = {"combiner": True} if comb else {}
                fitted = {
                    name: self.db.get(app, self.platform, cat,
                                      resource=rk)
                    for name, rk in res_keys.items()
                    if (app, self.platform, cat, rk) in self.db
                }
                if len(fitted) < len(res_keys):
                    profs = [
                        profile(
                            app, backend, int(row[3] * SIZE_UNIT),
                            int(row[0]), int(row[1]), int(row[2]),
                            **extra,
                        )
                        for row in rows
                    ]
                    targets = {
                        "bytes": [p["shuffle_bytes"] for p in profs],
                        "pre": [_pre_shuffle_wall(p["time_s"])
                                for p in profs],
                        "wall": [max(p["time_s"].get("shuffle", 0.0), 0.0)
                                 for p in profs],
                    }
                    for name, rk in res_keys.items():
                        if name in fitted:
                            continue
                        # Degree-1 bases fit the 12-point profile set
                        # without ever going underdetermined: bytes are
                        # ~linear in size, and the window-shape targets
                        # only steer dispatch, they gate nothing.
                        model = regression_fit(
                            rows,
                            np.asarray(targets[name], dtype=np.float64),
                            degree=1, cross_terms=False, scale=True,
                            lam=1e-9, device=FIT_DEVICE,
                        )
                        self.db.put(
                            app, self.platform, model, backend=cat,
                            resource=rk,
                        )
                        fitted[name] = model
                self._bytes_models[(app, backend, comb)] = fitted["bytes"]
                self._window_models[(app, backend, comb)] = (
                    fitted["pre"], fitted["wall"]
                )

    # ---- dispatch scoring ------------------------------------------------

    def _shuffle_window(
        self, job: JobSpec, plan: Plan, now: float
    ) -> tuple[float, float, float] | None:
        """Predicted fabric transfer (t0, t1, bytes/s) for this dispatch."""
        comb = bool(getattr(plan, "combiner", False))
        wmodels = self._window_models.get((job.app, plan.backend, comb))
        bmodel = self._bytes_models.get((job.app, plan.backend, comb))
        if wmodels is None or bmodel is None or plan.predicted_time is None:
            return None
        row = np.asarray(
            (plan.mappers, plan.reducers, plan.workers,
             job.size / SIZE_UNIT),
            dtype=np.float64,
        )
        nbytes = max(float(_np_predict(bmodel, row)[0]), 0.0)
        if nbytes <= 0.0:
            return None
        # Clamp the window inside the predicted runtime: the degree-1
        # window models may overshoot between profile points.
        pre = min(max(float(_np_predict(wmodels[0], row)[0]), 0.0),
                  plan.predicted_time)
        wall = min(max(float(_np_predict(wmodels[1], row)[0]), 1e-9),
                   max(plan.predicted_time - pre, 1e-9))
        return (now + pre, now + pre + wall, nbytes / wall)

    def _predicted_stretch(self, win: tuple[float, float, float]) -> float:
        """Fair-share seconds the fabric would add to this transfer given
        the predicted windows of running jobs: over every sub-interval of
        the window where aggregate demand D > capacity C, wire time
        inflates by D/C (the :class:`SharedFabric` law)."""
        t0, t1, rate = win
        edges = sorted(
            {t0, t1}
            | {p for (w0, w1, _) in self._windows.values()
               for p in (w0, w1) if t0 < p < t1}
        )
        extra = 0.0
        for a, b in zip(edges, edges[1:]):
            demand = rate + sum(
                r for (w0, w1, r) in self._windows.values()
                if w0 < b and w1 > a
            )
            if demand > self.net_capacity:
                extra += (b - a) * (demand / self.net_capacity - 1.0)
        return extra

    def select(self, queue, free_workers, now):
        # Windows whose transfer has closed no longer load the fabric.
        self._windows = {
            j: w for j, w in self._windows.items() if w[1] > now
        }
        best = None
        best_sjf = None  # what plain SJF would pick (deferral accounting)
        for job in queue:
            plan = self.best_plan(job, free_workers)
            if plan is None:
                continue
            win = (
                self._shuffle_window(job, plan, now)
                if math.isfinite(self.net_capacity) else None
            )
            stretch = self._predicted_stretch(win) if win else 0.0
            score = plan.predicted_time + self.contention_alpha * stretch
            if best is None or score < best[0]:
                best = (score, job, plan, win)
            if best_sjf is None or plan.predicted_time < best_sjf:
                best_sjf = plan.predicted_time
        if best is None:
            return None
        _, job, plan, win = best
        if best_sjf is not None and plan.predicted_time > best_sjf:
            self.n_contention_deferrals += 1
        if win is not None:
            self._windows[job.job_id] = win
        return Dispatch(job, plan)

    def observe(self, record):
        self._windows.pop(record.spec.job_id, None)
        super().observe(record)


@register_policy
class ElasticDeadline(DeadlineAware):
    """Deadline EDF + preemptive, regrant-aware elasticity.

    On a plain :class:`~repro_torch.cluster.cluster.Cluster` this is exactly
    ``predict-deadline``.  On an
    :class:`~repro_torch.elastic.sim.ElasticCluster` it adds two moves, each
    gated by the :class:`~repro_torch.elastic.regrant.RegrantCostModel` on the
    same regression basis every other decision uses:

    * **rescue (shrink)** — when a deadline job's cheapest feasible plan
      does not fit the free pool (the base policy would hold it while its
      budget burns), shrink a running *best-effort* job to the smallest
      grant in the worker grid at its next wave boundary, freeing workers
      in wave-time rather than job-time.  The cost model's ``shrink_ok``
      vetoes moves on nearly-finished victims or where the checkpoint
      overhead is large relative to the victim's predicted remaining run.
      While a shrink is in flight, the beneficiary is shielded from
      rejection and best-effort work is barred from backfilling the
      workers being freed.
    * **regrow** — once no queued deadline job needs the pool, previously
      shrunk jobs are grown back toward their original grant when the
      cost model predicts the regrant pays for itself
      (``worth_it``: time saved under W' exceeds the checkpoint cost).

    With no contention neither move triggers and the schedule is
    decision-for-decision identical to ``predict-deadline`` — which is
    the benchmark's no-regression guarantee.
    """

    name = "predict-elastic"

    def __init__(self, *, shrink_floor: int | None = None,
                 min_remaining_steps: int = 2,
                 min_remaining_frac: float = 0.15,
                 max_overhead_frac: float = 0.25,
                 regrow: bool = True, min_grow_gain_s: float = 1e-3,
                 suspend: bool = False,
                 **kwargs):
        super().__init__(**kwargs)
        self._shrink_floor_arg = shrink_floor
        if min_remaining_steps < 2:
            # A regrant can only take effect at a boundary *before* the
            # final wave; the simulator rejects later requests loudly.
            raise ValueError("min_remaining_steps must be >= 2")
        self.min_remaining_steps = int(min_remaining_steps)
        self.min_remaining_frac = float(min_remaining_frac)
        self.max_overhead_frac = float(max_overhead_frac)
        self.regrow = bool(regrow)
        self.min_grow_gain_s = float(min_grow_gain_s)
        #: suspend-to-disk rescue: when no shrinkable victim can free
        #: enough workers for a starved deadline job, park a whole
        #: best-effort job on disk (grant 0) and resume it once the pool
        #: quiets down.  Off by default: a suspended job pays the full
        #: disk-queue wait, so this is the aggressive setting.
        self.suspend = bool(suspend)
        self.n_shrinks = 0
        self.n_grows = 0
        self.n_suspends = 0
        self.n_resumes = 0
        self._awaiting: set[int] = set()

    def prepare(self, cluster, apps):
        super().prepare(cluster, apps)
        from repro_torch.elastic.regrant import RegrantCostModel

        self.elastic = bool(getattr(cluster, "supports_elastic", False))
        self.shrink_floor = (
            self._shrink_floor_arg if self._shrink_floor_arg is not None
            else min(self.worker_grid)
        )
        self.cost_model = RegrantCostModel(
            snapshot_overhead_s=getattr(
                cluster, "snapshot_overhead_s", 0.02
            ),
            restore_overhead_s=getattr(
                cluster, "restore_overhead_s", 0.02
            ),
            min_remaining_frac=self.min_remaining_frac,
            max_overhead_frac=self.max_overhead_frac,
        )
        self._awaiting.clear()

    def observe_overhead(self, save_s: float, restore_s: float) -> None:
        """Measured (snapshot, restore) walls from the cluster — the
        EngineOracle path measures real ``save_snapshot``/``load_snapshot``
        costs; folding them in keeps regrant pricing honest."""
        self.cost_model.record_overhead(save_s, restore_s)

    # ---- prediction on the regression basis -----------------------------

    def _predicted_total(self, spec: JobSpec, plan: Plan,
                         workers: int) -> float:
        """Model-predicted total time of (spec, plan) at grant ``workers``
        — the regression evaluated off the plan's frozen (M, R)."""
        model = self.db.get(
            spec.app, self.platform,
            backend=_cat_key(plan.backend, getattr(plan, "depth", 1),
                             getattr(plan, "combiner", False)),
        )
        row = np.asarray(
            (plan.mappers, plan.reducers, workers, spec.size / SIZE_UNIT),
            dtype=np.float64,
        )
        return float(max(_np_predict(model, row)[0], 1e-3))

    def _evaluate_regrant(self, view, new_workers: int):
        return self.cost_model.evaluate(
            t_total_current=self._predicted_total(
                view.spec, view.plan, view.workers
            ),
            t_total_new=self._predicted_total(
                view.spec, view.plan, new_workers
            ),
            progress=view.progress,
            current_workers=view.workers,
            new_workers=new_workers,
        )

    # ---- elastic decision layer -----------------------------------------

    def select(self, queue, free_workers, now):
        if not self.elastic:
            return super().select(queue, free_workers, now)
        views = self.cluster.running_jobs(now)
        pending_free = sum(
            v.workers - v.pending_workers for v in views
            if v.pending_workers is not None
            and v.pending_workers < v.workers
        )
        if pending_free == 0:
            # Nothing in flight: any previous rescue resolved (or died).
            self._awaiting.clear()
        action = self._maybe_rescue(queue, free_workers, pending_free,
                                    views, now)
        if action is not None:
            return action
        if self._awaiting:
            # Workers are being freed for awaited deadline jobs: other
            # deadline jobs proceed normally, but best-effort work must
            # not backfill the grant in flight, and the awaited jobs are
            # shielded from the base policy's rejection sweep.
            shielded = tuple(
                j for j in queue
                if j.deadline is not None and j.job_id not in self._awaiting
            )
            return super().select(shielded, free_workers, now) \
                if shielded else None
        action = self._maybe_regrow(queue, free_workers, views)
        if action is not None:
            return action
        return super().select(queue, free_workers, now)

    def idle(self, free_workers, now):
        """Elastic moves on an empty (or fully held) queue — the
        simulator calls this after the dispatch loop, which is the only
        chance to regrow right after the last queued job dispatched."""
        if not self.elastic or self._awaiting:
            return None
        return self._maybe_regrow(
            (), free_workers, self.cluster.running_jobs(now)
        )

    def _maybe_rescue(self, queue, free_workers, pending_free, views, now):
        """Shrink a running best-effort job to free workers for the most
        urgent deadline job that is feasible in time but starved of pool."""
        from repro_torch.elastic.sim import Regrant

        deadline_jobs = sorted(
            (j for j in queue if j.deadline is not None),
            key=lambda j: (j.deadline, j.arrival, j.job_id),
        )
        for job in deadline_jobs:
            budget = self._deadline_budget(job, now)
            fastest = self.best_plan(job, self.cluster.total_workers)
            if fastest is None or fastest.predicted_time > budget:
                self._awaiting.discard(job.job_id)
                continue    # hopeless: the base sweep will reject it
            if self._cheapest_feasible(job, free_workers, budget):
                self._awaiting.discard(job.job_id)
                continue    # dispatchable right now: base handles it
            target = self._cheapest_feasible(
                job, self.cluster.total_workers, budget
            )
            if target is None:
                continue
            deficit = target.workers - (free_workers + pending_free)
            if deficit <= 0:
                # Enough is already being freed; hold for the boundary.
                self._awaiting.add(job.job_id)
                continue
            victims = sorted(
                (
                    v for v in views
                    if v.spec.deadline is None
                    and v.pending_workers is None
                    and v.workers > self.shrink_floor
                    and v.steps_remaining >= self.min_remaining_steps
                ),
                key=lambda v: (-v.workers,
                               -v.progress.remaining_fraction(v.workers)),
            )
            for victim in victims:
                new_w = max(self.shrink_floor, victim.workers - deficit)
                decision = self._evaluate_regrant(victim, new_w)
                if not decision.shrink_ok:
                    continue
                self._awaiting.add(job.job_id)
                self.n_shrinks += 1
                return Regrant(
                    victim.job_id, new_w,
                    reason=f"rescue deadline job {job.job_id} "
                           f"(gain gate: {decision.gain_s:+.3f}s)",
                )
            if self.suspend:
                # No shrinkable victim can free enough (typically: the
                # best-effort jobs already sit at the shrink floor).
                # Park one on disk entirely — its whole grant frees at
                # the next wave boundary.
                for victim in sorted(
                    (
                        v for v in views
                        if v.spec.deadline is None
                        and v.pending_workers is None
                        and v.steps_remaining >= self.min_remaining_steps
                    ),
                    key=lambda v: (-v.workers,
                                   -v.progress.remaining_fraction(
                                       v.workers)),
                ):
                    # Gate on the cost model's most aggressive shrink:
                    # suspension is never cheaper than shrinking to 1.
                    if not self._evaluate_regrant(victim, 1).shrink_ok:
                        continue
                    self._awaiting.add(job.job_id)
                    self.n_suspends += 1
                    return Regrant(
                        victim.job_id, 0,
                        reason=f"suspend to disk: rescue deadline job "
                               f"{job.job_id}",
                    )
        return None

    def _maybe_regrow(self, queue, free_workers, views):
        """Grow a shrunk job back toward its original grant when the pool
        is quiet and the cost model predicts the move pays for itself."""
        from repro_torch.elastic.sim import Regrant

        if free_workers <= 0:
            return None
        if any(j.deadline is not None for j in queue):
            return None     # deadline work queued: keep the slack
        # Resume suspended-to-disk jobs first: they hold zero workers and
        # pay full queue wait, so any slack goes to them before regrows.
        # NOT gated on self.regrow — a suspended job must always have a
        # path back, or the simulator (rightly) reports it stranded.
        suspended = getattr(self.cluster, "suspended_jobs", None)
        if suspended is not None:
            for sus in suspended():
                w = min(sus.workers_before, free_workers)
                if w >= 1:
                    self.n_resumes += 1
                    return Regrant(
                        sus.job_id, w,
                        reason="resume from disk (pool quiet)",
                    )
        if not self.regrow:
            return None
        candidates = sorted(
            (
                v for v in views
                if v.shrunk_from is not None
                and v.pending_workers is None
                and v.workers < v.shrunk_from
                and v.steps_remaining >= self.min_remaining_steps
            ),
            key=lambda v: v.started,
        )
        for victim in candidates:
            new_w = min(victim.shrunk_from, victim.workers + free_workers)
            if new_w <= victim.workers:
                continue
            decision = self._evaluate_regrant(victim, new_w)
            if decision.gain_s > self.min_grow_gain_s:
                self.n_grows += 1
                return Regrant(
                    victim.job_id, new_w,
                    reason=f"regrow (predicted gain {decision.gain_s:.3f}s)",
                )
        return None
