"""Command-line entry point of the predictive cluster scheduler
(counterpart of ``repro.launch.cluster``).

    PYTHONPATH=src python -m repro_torch.launch.cluster --device cpu \
        --jobs 20 --workers 8 --policies fifo-static,predict-sjf

Runs the named scheduling policies over one shared deterministic trace and
prints a comparison table plus the online-refinement error trajectory.
``--save-models`` persists the fitted per-(app, platform, backend) models
(the paper's model database) so a later run — or a real long-lived
scheduler — can ``--load-models`` and skip the bootstrap profiling phase.
``--oracle engine`` wall-clocks the live MapReduce engine on ``--device``
(default ``cuda``) instead of the analytic cost (every distinct config
builds one plan and pays one warmup run); ``--oracle engine-traced`` runs
it through the telemetry path.  ``--oracle engine-sharded`` runs each
grant W traced on a world of W rank processes (NCCL, one card a rank; gloo
with ``--device cpu``), so jobs carry per-phase walls measured on the
sharded path; a grant above the visible devices raises.
``--overlap-depth 1,2,4`` widens every predictive policy's category grid
with the pipelined execution mode's overlap depth, so plans carry a
per-job depth choice (the ``depths`` column histograms what was picked).
``--combiner`` widens the grid along the map-side-combine axis instead:
each predictive policy profiles every backend with the combiner off *and*
on and chooses per job (the ``comb`` column histograms the choice; the
``predict-combine`` policy tunes this axis even without the flag).
``--elastic`` runs the trace on the :class:`repro_torch.elastic.ElasticCluster`,
where the ``predict-elastic`` policy may preempt running jobs at wave
boundaries and shrink/grow their worker grants (``--ckpt-overhead`` /
``--restore-overhead`` price each move); other policies run unchanged on
the elastic simulator, so the comparison stays apples-to-apples.

``--service`` switches from draining a fixed trace to *serving* an
open-ended arrival stream (``--stream flash|diurnal|bursty|constant``)
until ``--duration`` sim seconds and/or ``--until-jobs`` arrivals::

    PYTHONPATH=src python -m repro_torch.launch.cluster \
        --service --elastic --duration 900 --stream flash \
        --slo-p99 6 --admission burn,static --health-every 60

Each ``--admission`` arm (``burn`` = SLO burn-rate overload control,
``static`` = fixed queue cap, ``none`` = admit everything) serves the
identical stream; a health line prints every ``--health-every`` sim
seconds with queue/worker gauges and the windowed p99, and the final
table compares exact p99 turnaround and SLO-good goodput per arm.
``--metrics-out x.prom`` writes Prometheus text exposition instead of
JSON (both modes).
"""

from __future__ import annotations

import argparse
import json
import math
import os

from repro_torch.cluster import (
    AnalyticOracle,
    Cluster,
    EngineOracle,
    JobStream,
    POLICIES,
    PoissonProcess,
    PredictivePolicy,
    RenewalProcess,
    assign_deadlines,
    constant_rate,
    diurnal_rate,
    flash_crowd_rate,
    generate_workload,
    get_policy,
)
from repro_torch.core.predictor import ModelDatabase
from repro_torch.obs import (
    ClusterMetrics,
    ControlledPolicy,
    OverloadController,
    PredictionLedger,
    SLOMonitor,
    SLOPolicy,
    SpanRecorder,
    StaticAdmission,
    get_logger,
    render_slots,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.cluster",
        description="Prediction-driven multi-job MapReduce scheduling",
    )
    ap.add_argument("--jobs", type=int, default=60)
    ap.add_argument("--workers", type=int, default=16)
    ap.add_argument("--policies", default="all",
                    help="comma list of policy names, or 'all'")
    ap.add_argument("--arrival", default="poisson",
                    choices=("poisson", "uniform", "bursty"))
    ap.add_argument("--mean-interarrival", type=float, default=0.12)
    ap.add_argument("--size-min", type=int, default=1 << 14)
    ap.add_argument("--size-max", type=int, default=1 << 18)
    ap.add_argument("--deadline-fraction", type=float, default=0.6,
                    help="fraction of jobs carrying an SLO deadline")
    ap.add_argument("--slack", type=float, nargs=2, default=(1.2, 6.0),
                    metavar=("LO", "HI"),
                    help="deadline slack multiplier range")
    ap.add_argument("--noise", type=float, default=0.02,
                    help="analytic-oracle runtime noise (lognormal sigma)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--oracle", default="analytic",
                    choices=("analytic", "engine", "engine-traced",
                             "engine-sharded"),
                    help="'engine-traced' wall-clocks the live engine "
                         "through the telemetry path: completed jobs carry "
                         "per-phase traces and the online refiner fits "
                         "decomposed per-phase models; 'engine-sharded' "
                         "runs each grant W on W rank processes, so "
                         "per-phase times come from the sharded engine")
    ap.add_argument("--device", default="cuda",
                    help="device the engine oracles run their jobs on "
                         "('cuda' or 'cpu'; asking for the card without "
                         "one raises)")
    ap.add_argument("--overlap-depth", default=None, metavar="D1,D2,...",
                    help="overlap-depth grid for predictive policies "
                         "(e.g. '1,2,4'): each depth becomes one more "
                         "profiled category and plans carry the chosen "
                         "depth per job (default: policy-specific — "
                         "predict-pipeline tunes 1,2,4; others stay at 1)")
    ap.add_argument("--combiner", action="store_true",
                    help="widen every predictive policy's category grid "
                         "with the map-side combine axis: each backend is "
                         "profiled with the combiner off and on, and plans "
                         "carry a per-job combiner choice (the 'comb' "
                         "column histograms what was picked; default: "
                         "policy-specific — predict-combine tunes off+on, "
                         "others stay off)")
    ap.add_argument("--net-capacity", type=float, default=None,
                    help="shared shuffle-fabric bytes/s budget: the "
                         "simulated ground truth fair-share-stretches "
                         "overlapping shuffles past it (contention shows "
                         "up in every policy's makespan and in the "
                         "exported trace), and the predict-resource "
                         "policy schedules against it (default: "
                         "unconstrained fabric)")
    ap.add_argument("--elastic", action="store_true",
                    help="run on the ElasticCluster: running jobs may be "
                         "preempted at wave boundaries and regranted "
                         "(the predict-elastic policy exploits this; "
                         "other policies behave as on the base cluster)")
    ap.add_argument("--ckpt-overhead", type=float, default=0.02,
                    help="simulated snapshot cost per preemption, seconds "
                         "(engine oracles override this with measured "
                         "save_snapshot walls)")
    ap.add_argument("--restore-overhead", type=float, default=0.02,
                    help="simulated restore cost per preemption, seconds "
                         "(engine oracles override this with measured "
                         "load_snapshot walls)")
    ap.add_argument("--suspend", action="store_true",
                    help="with --elastic: let predict-elastic suspend "
                         "best-effort jobs to disk (grant 0) when "
                         "shrinking cannot free enough workers for a "
                         "starved deadline job")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="export each policy's run as Chrome trace-event "
                         "JSON (open in Perfetto / chrome://tracing); with "
                         "several policies the policy name is suffixed "
                         "onto the stem.  Also prints the per-worker-slot "
                         "ASCII timeline for small clusters")
    ap.add_argument("--metrics-out", metavar="PATH",
                    help="write per-policy service metrics (streaming "
                         "p50/p99 turnaround + wait, goodput, regrant "
                         "overhead) as one JSON object keyed by policy")
    ap.add_argument("--drift-ledger", action="store_true",
                    help="attach a PredictionLedger to every predictive "
                         "policy: records predicted-vs-realized per "
                         "category, raises drift alarms, and triggers "
                         "category-targeted refits")
    svc = ap.add_argument_group(
        "service mode", "serve an open-ended arrival stream instead of "
        "draining a fixed trace; see module docstring for an example"
    )
    svc.add_argument("--service", action="store_true",
                     help="run in service mode: jobs come from --stream "
                          "until --duration / --until-jobs, admission is "
                          "per --admission, and a health line prints "
                          "every --health-every sim seconds")
    svc.add_argument("--duration", type=float, default=None,
                     help="service horizon in sim seconds (arrivals stop "
                          "here; admitted jobs drain to completion)")
    svc.add_argument("--until-jobs", type=int, default=None,
                     help="stop the stream after this many arrivals "
                          "(composes with --duration: first bound wins)")
    svc.add_argument("--stream", default="flash",
                     choices=("constant", "diurnal", "bursty", "flash"),
                     help="arrival process: constant/diurnal/flash are "
                          "Poisson (flash = diurnal base hit by --crowd "
                          "windows), bursty is the renewal process")
    svc.add_argument("--rate", type=float, default=0.85,
                     help="base arrival rate, jobs/s")
    svc.add_argument("--crowd", type=float, nargs=3, action="append",
                     metavar=("T0", "T1", "FACTOR"), default=None,
                     help="flash-crowd window: rate multiplies by FACTOR "
                          "for t in [T0, T1); repeatable (default: one "
                          "4.5x crowd at 120..200 s)")
    svc.add_argument("--admission", default="burn,static",
                     help="comma list of admission arms to serve the "
                          "same stream: burn (SLO burn-rate overload "
                          "control), static (fixed queue cap), none")
    svc.add_argument("--slo-p99", type=float, default=6.0,
                     help="SLO: good = turnaround within this, seconds")
    svc.add_argument("--slo-objective", type=float, default=0.95,
                     help="fraction of completions that must be good")
    svc.add_argument("--queue-floor", type=int, default=4,
                     help="burn arm sheds queued jobs down to this depth "
                          "while the alarm is tripped")
    svc.add_argument("--static-cap", type=int, default=12,
                     help="static arm rejects arrivals beyond this "
                          "queue depth, alarm or no alarm")
    svc.add_argument("--health-every", type=float, default=60.0,
                     help="health-line period, sim seconds (0 disables)")
    svc.add_argument("--window", type=float, default=60.0,
                     help="sliding-window width for the windowed "
                          "p50/p99/rate gauges in health lines")
    svc.add_argument("--retain-jobs", type=int, default=None,
                     help="with --trace-out: SpanRecorder ring retention "
                          "— keep spans for only the last N completed "
                          "jobs (default: keep everything)")
    ap.add_argument("--log-level", default="info",
                    choices=("debug", "info", "warning", "error"))
    ap.add_argument("--log-json", action="store_true",
                    help="emit status lines as JSON objects (one per "
                         "line) on stderr instead of human-readable text")
    ap.add_argument("--save-models", metavar="PATH",
                    help="persist the fitted ModelDatabase as JSON")
    ap.add_argument("--load-models", metavar="PATH",
                    help="warm-start predictive policies from a saved "
                         "ModelDatabase (skips bootstrap profiling)")
    ap.add_argument("--json", metavar="PATH",
                    help="also dump per-policy metrics as JSON")
    return ap


def _trace_path(base: str, policy: str, many: bool) -> str:
    if not many:
        return base
    root, ext = os.path.splitext(base)
    return f"{root}.{policy}{ext or '.json'}"


# --------------------------------------------------------------- service mode


def _build_stream(args) -> JobStream:
    """One seeded open-ended stream per --stream choice; every arm
    re-iterates it from scratch, so all arms see the identical jobs."""
    if args.stream == "bursty":
        process = RenewalProcess(
            "bursty", mean_interarrival=1.0 / args.rate, seed=args.seed
        )
    else:
        if args.stream == "constant":
            rate_fn, peak = constant_rate(args.rate), args.rate
        else:
            rate_fn = diurnal_rate(args.rate, amplitude=0.3, period_s=600.0)
            peak = args.rate * 1.3
            if args.stream == "flash":
                crowds = [
                    tuple(c) for c in (args.crowd or [[120.0, 200.0, 4.5]])
                ]
                rate_fn = flash_crowd_rate(rate_fn, crowds)
                peak *= max(f for _, _, f in crowds)
        process = PoissonProcess(rate_fn, peak_rate=peak, seed=args.seed)
    return JobStream(
        process, seed=args.seed,
        size_range=(args.size_min, args.size_max),
    )


def _service_arm(kind: str, args, inner):
    """(policy, controller, monitor) for one --admission arm."""
    if kind == "none":
        return inner, None, None
    if kind == "static":
        ctrl = StaticAdmission(args.static_cap)
        return ControlledPolicy(inner, ctrl), ctrl, None
    if kind == "burn":
        monitor = SLOMonitor(
            SLOPolicy(args.slo_p99, objective=args.slo_objective)
        )
        ctrl = OverloadController(monitor, queue_floor=args.queue_floor)
        return ControlledPolicy(inner, ctrl), ctrl, monitor
    raise SystemExit(
        f"unknown --admission arm {kind!r}; expected burn|static|none"
    )


def _exact_quantile(xs, q: float):
    """ceil-index order statistic (the convention the P² windows target)."""
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]


def _fabric_kwargs(args, oracle, log) -> dict:
    """Validated ``net_capacity`` kwarg for cluster construction.

    A fabric budget is only honest when the ground truth can price it:
    the elastic simulator has no shared-fabric event loop, and an oracle
    without ``prices_contention`` (an untraced engine oracle) yields no
    per-phase shuffle windows to stretch.  Refusing loudly beats running
    a silently uncontended "contended" experiment.
    """
    if args.net_capacity is None:
        return {}
    if args.elastic:
        log.warning(
            "net_capacity_rejected", capacity=args.net_capacity,
            reason="elastic",
            msg="--net-capacity needs the base cluster's shared-fabric "
                "event loop; the elastic simulator does not price "
                "contention",
        )
        raise SystemExit("--net-capacity is incompatible with --elastic")
    if not getattr(oracle, "prices_contention", False):
        log.warning(
            "net_capacity_rejected", capacity=args.net_capacity,
            reason="oracle", oracle=oracle.platform,
            msg=f"oracle {oracle.platform!r} cannot price fabric "
                "contention (no per-phase shuffle windows); use the "
                "analytic oracle or a traced engine oracle",
        )
        raise SystemExit(
            f"--net-capacity rejected: oracle {oracle.platform!r} cannot "
            "price contention"
        )
    return {"net_capacity": args.net_capacity}


def _run_service(args, oracle, log) -> None:
    if args.duration is None and args.until_jobs is None:
        raise SystemExit("--service needs --duration and/or --until-jobs")
    if args.rate <= 0:
        raise SystemExit("--rate must be > 0")
    arms = [a.strip() for a in args.admission.split(",") if a.strip()]
    if not arms:
        raise SystemExit("--admission must name at least one arm")
    inner_name = ("fifo-static" if args.policies == "all"
                  else args.policies.split(",")[0])
    log.info(
        "service",
        msg=f"serving --stream {args.stream} at base {args.rate:g} jobs/s "
            f"on {args.workers} workers, policy {inner_name}, "
            f"arms: {', '.join(arms)}",
        stream=args.stream, rate=args.rate, policy=inner_name, arms=arms,
    )
    fabric_kwargs = _fabric_kwargs(args, oracle, log)
    out: dict[str, dict] = {}
    registries: dict[str, object] = {}
    for kind in arms:
        kwargs: dict = {}
        if issubclass(POLICIES[inner_name], PredictivePolicy):
            kwargs["seed"] = args.seed
            if args.combiner:
                kwargs["combiner_grid"] = (False, True)
        policy, ctrl, monitor = _service_arm(
            kind, args, get_policy(inner_name, **kwargs)
        )
        metrics = ClusterMetrics(window_s=args.window or None)
        if args.elastic:
            from repro_torch.elastic import ElasticCluster

            cluster = ElasticCluster(
                args.workers, oracle,
                snapshot_overhead_s=args.ckpt_overhead,
                restore_overhead_s=args.restore_overhead,
            )
        else:
            cluster = Cluster(args.workers, oracle, **fabric_kwargs)
        cluster.metrics = metrics

        def on_health(now, snap, kind=kind):
            w = snap.get("windowed") or {}
            p99 = w.get("p99_turnaround_s")
            log.info(
                "health", arm=kind, t=round(now, 1),
                queue=snap["queue_depth"], busy=snap["busy_workers"],
                suspended=snap["suspended_jobs"], windowed_p99_s=p99,
                msg=f"[{kind:>6}] t={now:8.1f}  "
                    f"queue={snap['queue_depth']:>3}  "
                    f"busy={snap['busy_workers']:>2}/{args.workers}  "
                    f"susp={snap['suspended_jobs']}  win p99="
                    f"{'n/a' if p99 is None else format(p99, '.2f') + 's'}",
            )

        result = cluster.run_service(
            _build_stream(args), policy,
            until_time=args.duration, until_jobs=args.until_jobs,
            health_every=args.health_every or None,
            on_health=on_health if args.health_every else None,
        )

        done = [r for r in result.records if r.completed]
        turn = [r.turnaround for r in done]
        good = [r for r in done if r.turnaround <= args.slo_p99]
        t0 = min((r.spec.arrival for r in result.records), default=0.0)
        t_end = max((r.finish for r in done), default=t0)
        alarms = monitor.alarms if monitor is not None else []
        for a in alarms:
            log.info(
                "alarm", arm=kind, transition=a.event, t=round(a.t, 2),
                msg=f"[{kind:>6}] {a.event:<5} at t={a.t:8.1f}  "
                    f"burn fast={a.burn_fast:.2f} slow={a.burn_slow:.2f}",
            )
        out[kind] = {
            "arm": policy.name,
            "n_arrived": len(result.records),
            "n_completed": len(done),
            "n_rejected": sum(
                1 for r in result.records if not r.admitted
            ),
            "n_good": len(good),
            "p50_turnaround_s": _exact_quantile(turn, 0.5),
            "p99_turnaround_s": _exact_quantile(turn, 0.99),
            # SLO-good tokens per second: completions that blew the
            # target spent capacity without serving anyone in time.
            "goodput_tokens_per_s": (
                sum(r.spec.size for r in good) / (t_end - t0)
                if t_end > t0 else None
            ),
            "n_sheds": (
                sum(1 for a in ctrl.log if a.action == "shed")
                if ctrl is not None else 0
            ),
            "n_suspends": (
                sum(1 for a in ctrl.log if a.action == "suspend")
                if ctrl is not None else 0
            ),
            "n_alarms": len(alarms),
            "budget_remaining_frac": (
                monitor.budget()["remaining_frac"]
                if monitor is not None else None
            ),
            "service": metrics.summary(),
        }
        registries[kind] = metrics.registry
        if args.trace_out:
            rec = SpanRecorder(max_jobs=args.retain_jobs)
            rec.record(
                result,
                control_log=ctrl.log if ctrl is not None else None,
            )
            violations = rec.check()
            if violations:
                log.warning(
                    "span_tiling", arm=kind, n=len(violations),
                    msg=f"{kind}: {len(violations)} span-tiling "
                        f"violations (trace still exported)",
                )
            path = _trace_path(args.trace_out, kind, len(arms) > 1)
            rec.save_chrome(path)
            log.info(
                "trace_out", arm=kind, path=path,
                msg=f"{kind}: wrote Chrome trace -> {path}",
            )

    def f(x, nd=2):
        return "n/a" if x is None else f"{x:.{nd}f}"

    hdr = (
        f"{'arm':<30} {'done':>5} {'rej':>5} {'good':>5} {'p50':>7} "
        f"{'p99':>7} {'goodput':>9} {'shed':>5} {'susp':>5} "
        f"{'alarms':>6} {'budget':>7}"
    )
    print(hdr)
    print("-" * len(hdr))
    for kind in arms:
        m = out[kind]
        print(
            f"{m['arm']:<30} {m['n_completed']:>5} {m['n_rejected']:>5} "
            f"{m['n_good']:>5} {f(m['p50_turnaround_s']):>7} "
            f"{f(m['p99_turnaround_s']):>7} "
            f"{f(m['goodput_tokens_per_s'], 0):>9} {m['n_sheds']:>5} "
            f"{m['n_suspends']:>5} {m['n_alarms']:>6} "
            f"{f(m['budget_remaining_frac'], 3):>7}"
        )
    if args.metrics_out:
        if args.metrics_out.endswith(".prom"):
            for kind in arms:
                path = _trace_path(args.metrics_out, kind, len(arms) > 1)
                registries[kind].save_prom(path)
                log.info(
                    "metrics_out", arm=kind, path=path,
                    msg=f"{kind}: wrote Prometheus text -> {path}",
                )
        else:
            with open(args.metrics_out, "w") as fp:
                json.dump(out, fp, indent=1, sort_keys=True)
            log.info(
                "metrics_out", path=args.metrics_out,
                msg=f"wrote service metrics -> {args.metrics_out}",
            )
    if args.json:
        with open(args.json, "w") as fp:
            json.dump(out, fp, indent=1, sort_keys=True)
        log.info(
            "json_out", path=args.json,
            msg=f"wrote metrics -> {args.json}",
        )


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    log = get_logger(
        "cluster", level=args.log_level, json_lines=args.log_json
    )
    depth_grid = None
    if args.overlap_depth is not None:
        depth_grid = tuple(
            int(d) for d in args.overlap_depth.split(",") if d.strip()
        )
    deep = depth_grid is not None and max(depth_grid) > 1
    if args.oracle in ("engine", "engine-traced", "engine-sharded"):
        if deep and args.oracle == "engine-sharded":
            raise SystemExit(
                "--overlap-depth > 1 is a single-controller schedule; "
                "it does not compose with --oracle engine-sharded"
            )
        oracle = EngineOracle(
            traced=args.oracle in ("engine-traced", "engine-sharded"),
            sharded=args.oracle == "engine-sharded",
            pipelined=deep, device=args.device,
        )
        log.info(
            "engine_oracle",
            msg="note: the engine oracle builds a plan and pays a warmup "
                "run for every distinct (app, size, backend, M, R, W) — "
                "predictive policies' bootstrap profiling alone is ~100+ "
                "configurations at the default grids",
        )
    else:
        oracle = AnalyticOracle(noise=args.noise, seed=args.seed)

    try:
        if args.service:
            _run_service(args, oracle, log)
        else:
            _run_trace(args, oracle, log, depth_grid)
    finally:
        if isinstance(oracle, EngineOracle):
            oracle.close()  # the engine-sharded oracle's rank processes


def _run_trace(args, oracle, log, depth_grid) -> None:
    """Drain one generated trace under each named policy."""
    jobs = generate_workload(
        args.jobs, seed=args.seed, arrival=args.arrival,
        mean_interarrival=args.mean_interarrival,
        size_range=(args.size_min, args.size_max),
    )
    if args.deadline_fraction > 0:
        jobs = assign_deadlines(
            jobs, lambda j: oracle.nominal_time(j.app, j.size),
            slack_range=tuple(args.slack), fraction=args.deadline_fraction,
            seed=args.seed + 1,
        )
    names = (sorted(POLICIES) if args.policies == "all"
             else args.policies.split(","))
    fabric_kwargs = _fabric_kwargs(args, oracle, log)
    if args.elastic:
        from repro_torch.elastic import ElasticCluster

        cluster = ElasticCluster(
            args.workers, oracle,
            snapshot_overhead_s=args.ckpt_overhead,
            restore_overhead_s=args.restore_overhead,
        )
    else:
        cluster = Cluster(args.workers, oracle, **fabric_kwargs)

    header = (
        f"{'policy':<18} {'makespan':>9} {'wait':>7} {'turnaround':>10} "
        f"{'util':>5} {'SLO':>5} {'rej':>4} {'rgr':>4} {'MAE%':>6} "
        f"{'MAE% 1st→2nd half':>18} {'depths':>12} {'comb':>11}"
    )
    log.info(
        "run",
        msg=f"{args.jobs} jobs, {args.workers} workers, "
            f"arrival={args.arrival}, oracle={oracle.platform}",
        jobs=args.jobs, workers=args.workers, arrival=args.arrival,
        oracle=oracle.platform,
    )
    print(header)
    print("-" * len(header))
    all_metrics: dict[str, dict] = {}
    service: dict[str, dict] = {}
    prom_registries: dict[str, object] = {}
    save_db = None
    for name in names:
        kwargs: dict = {}
        ledger = None
        if issubclass(POLICIES[name], PredictivePolicy):
            kwargs["seed"] = args.seed
            if depth_grid is not None:
                kwargs["depth_grid"] = depth_grid
            if args.combiner:
                kwargs["combiner_grid"] = (False, True)
            if name == "predict-resource" and args.net_capacity is not None:
                kwargs["net_capacity"] = args.net_capacity
            if name == "predict-elastic" and args.suspend:
                kwargs["suspend"] = True
            if args.drift_ledger:
                ledger = PredictionLedger()
                kwargs["ledger"] = ledger
            if args.load_models:
                # Fresh copy per policy: online refits mutate the db, and
                # a shared instance would make the comparison depend on
                # policy iteration order.
                kwargs["db"] = ModelDatabase.load(args.load_models)
        policy = get_policy(name, **kwargs)
        metrics = ClusterMetrics()
        cluster.metrics = metrics
        result = cluster.run(jobs, policy)
        m = result.metrics()
        all_metrics[name] = m
        service[name] = metrics.summary()
        service[name]["drift_alarms"] = getattr(policy, "n_drift_alarms", 0)
        if args.metrics_out:
            prom_registries[name] = metrics.registry
            all_metrics[name]["service"] = metrics.to_dict()
            if ledger is not None:
                all_metrics[name]["drift"] = ledger.to_dict()
        if args.trace_out:
            rec = SpanRecorder()
            rec.record(result)
            violations = rec.check()
            if violations:
                log.warning(
                    "span_tiling", policy=name, n=len(violations),
                    msg=f"{name}: {len(violations)} span-tiling "
                        f"violations (trace still exported)",
                )
            path = _trace_path(args.trace_out, name, len(names) > 1)
            rec.save_chrome(path)
            log.info(
                "trace_out", policy=name, path=path,
                msg=f"{name}: wrote Chrome trace -> {path}",
            )

        def f(x, nd=2):
            return "  n/a" if x is None else f"{x:.{nd}f}"

        halves = (
            f"{f(m['pred_mae_pct_first_half'], 1)}→"
            f"{f(m['pred_mae_pct_second_half'], 1)}"
            if m["pred_mae_pct"] is not None else "n/a"
        )
        depths = "+".join(
            f"{d}:{n}" for d, n in sorted(
                m["depth_histogram"].items(), key=lambda kv: int(kv[0])
            )
        )
        comb = "+".join(
            f"{k}:{n}" for k, n in sorted(m["combiner_histogram"].items())
        )
        print(
            f"{name:<18} {f(m['makespan_s']):>9} {f(m['mean_wait_s']):>7} "
            f"{f(m['mean_turnaround_s']):>10} {f(m['utilization']):>5} "
            f"{f(m['slo_attainment']):>5} {m['n_rejected']:>4} "
            f"{m['n_regrants']:>4} {f(m['pred_mae_pct'], 1):>6} "
            f"{halves:>18} {depths:>12} {comb:>11}"
        )
        if hasattr(policy, "db"):
            save_db = policy.db

    def g(x, nd=3):
        return "  n/a" if x is None else f"{x:.{nd}f}"

    shdr = (
        f"{'policy':<18} {'p50 trn':>8} {'p99 trn':>8} {'p50 wait':>8} "
        f"{'p99 wait':>8} {'goodput':>9} {'rgr ovh':>8} {'alarms':>6}"
    )
    print("\nservice metrics (streaming quantiles):")
    print(shdr)
    print("-" * len(shdr))
    for name, s in service.items():
        print(
            f"{name:<18} {g(s['p50_turnaround_s']):>8} "
            f"{g(s['p99_turnaround_s']):>8} {g(s['p50_wait_s']):>8} "
            f"{g(s['p99_wait_s']):>8} {g(s['goodput_tokens_per_s'], 0):>9} "
            f"{g(s['regrant_overhead_total_s']):>8} "
            f"{s['drift_alarms']:>6}"
        )
    if args.trace_out and args.workers <= 32:
        print("\nper-slot timeline (last policy):")
        print(render_slots(result))
    if args.save_models:
        if save_db is None or len(save_db) == 0:
            log.warning(
                "save_models",
                msg="no fitted models to save (only baseline policies ran)",
            )
        else:
            save_db.save(args.save_models)
            log.info(
                "save_models", n=len(save_db), path=args.save_models,
                msg=f"saved {len(save_db)} models -> {args.save_models}",
            )
    if args.metrics_out:
        if args.metrics_out.endswith(".prom"):
            for name in names:
                path = _trace_path(args.metrics_out, name, len(names) > 1)
                prom_registries[name].save_prom(path)
                log.info(
                    "metrics_out", policy=name, path=path,
                    msg=f"{name}: wrote Prometheus text -> {path}",
                )
        else:
            with open(args.metrics_out, "w") as fp:
                json.dump(
                    {n: all_metrics[n] for n in names}, fp,
                    indent=1, sort_keys=True,
                )
            log.info(
                "metrics_out", path=args.metrics_out,
                msg=f"wrote service metrics -> {args.metrics_out}",
            )
    if args.json:
        with open(args.json, "w") as fp:
            json.dump(all_metrics, fp, indent=1, sort_keys=True)
        log.info(
            "json_out", path=args.json,
            msg=f"wrote metrics -> {args.json}",
        )


if __name__ == "__main__":
    main()
