"""Live-service walkthrough: flash crowd, burn-rate alarm, overload control
(counterpart of ``examples/service_overload.py``; analytic, host only).

    PYTHONPATH=src python -m repro_torch.service_overload [--trace-out PATH]

Serves one seed-deterministic arrival stream — a diurnal Poisson base
hit by a 4.5x flash crowd — twice on the same 8-worker elastic cluster:

1. **no admission control**: every arrival is queued; the crowd backlog
   pushes p99 turnaround to minutes;
2. **burn-rate overload control**: an ``SLOMonitor`` watches the
   completion stream through fast/slow sliding windows, trips a burn
   alarm when the error budget is being consumed too fast, and an
   ``OverloadController`` sheds from the queue head and opens the
   suspend-to-disk valve until the budget recovers.

Along the way it prints the windowed health snapshots, the alarm
transitions, and the controller's auditable decision log — then the
final comparison, plus where the Chrome trace (with its "slo control"
track) landed (``--trace-out``, ``service_overload.trace.json`` by
default).  Every line but that path is deterministic from the seed.
"""

from __future__ import annotations

import argparse

from repro_torch.cluster import (
    AnalyticOracle,
    JobStream,
    PoissonProcess,
    diurnal_rate,
    flash_crowd_rate,
    get_policy,
)
from repro_torch.elastic import ElasticCluster
from repro_torch.obs import (
    ClusterMetrics,
    ControlledPolicy,
    OverloadController,
    SLOMonitor,
    SLOPolicy,
    SpanRecorder,
)

SLO_TARGET_S = 6.0       # good = turnaround within 6 s
N_JOBS = 400


def make_stream():
    """~0.85 jobs/s diurnal base; 4.5x flash crowd over t in [120, 200)."""
    rate = flash_crowd_rate(
        diurnal_rate(0.85, amplitude=0.3, period_s=600.0),
        [(120.0, 200.0, 4.5)],
    )
    return JobStream(
        PoissonProcess(rate, peak_rate=0.85 * 1.3 * 4.5, seed=11), seed=11
    )


def serve(policy, label):
    metrics = ClusterMetrics(window_s=30.0)
    cluster = ElasticCluster(8, AnalyticOracle(noise=0.02, seed=11))
    cluster.metrics = metrics

    def on_health(now, snap):
        w = snap.get("windowed") or {}
        p99 = w.get("p99_turnaround_s")
        print(f"  [{label}] t={now:6.1f}  queue={snap['queue_depth']:>3}  "
              f"busy={snap['busy_workers']}/8  "
              f"susp={snap['suspended_jobs']}  win p99="
              f"{'n/a' if p99 is None else format(p99, '.2f') + 's'}")

    result = cluster.run_service(
        make_stream(), policy, until_jobs=N_JOBS,
        health_every=60.0, on_health=on_health,
    )
    done = sorted(r.turnaround for r in result.records if r.completed)
    p99 = done[max(0, round(0.99 * len(done)) - 1)]
    good = sum(1 for t in done if t <= SLO_TARGET_S)
    print(f"  [{label}] completed={len(done)}  "
          f"rejected={sum(1 for r in result.records if not r.admitted)}  "
          f"good={good}  p99={p99:.2f}s")
    return result, p99


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-out", default="service_overload.trace.json",
                    help="where the controlled run's Chrome trace goes")
    args = ap.parse_args(argv)

    print(f"=== arm 1: no admission control ({N_JOBS} jobs) ===")
    _, p99_naive = serve(get_policy("fifo-static"), "naive")

    print("\n=== arm 2: burn-rate overload control ===")
    monitor = SLOMonitor(
        SLOPolicy(SLO_TARGET_S, objective=0.95),
        fast_window_s=15.0, slow_window_s=60.0,
        trip_burn=1.5, clear_burn=0.5,
    )
    controller = OverloadController(monitor, queue_floor=4, max_suspended=1)
    policy = ControlledPolicy(get_policy("fifo-static"), controller)
    result, p99_ctrl = serve(policy, "burn")

    print("\nalarm transitions:")
    for a in monitor.alarms:
        print(f"  {a.event:<5} t={a.t:7.1f}  burn fast={a.burn_fast:5.2f} "
              f"slow={a.burn_slow:5.2f}  "
              f"budget remaining={a.budget_remaining_frac:+.2f}")

    print("\ncontroller decision log (first 10):")
    for a in controller.log[:10]:
        who = "" if a.job_id is None else f" job {a.job_id}"
        print(f"  t={a.t:7.1f}  {a.action:<7}{who:<9} {a.reason}")
    print(f"  ... {len(controller.log)} decisions total: "
          f"{sum(1 for a in controller.log if a.action == 'shed')} sheds, "
          f"{sum(1 for a in controller.log if a.action == 'suspend')} "
          f"suspends")

    budget = monitor.budget()
    print(f"\nerror budget: {budget['bad_events']} bad of "
          f"{budget['events']} completions "
          f"(allowed {budget['allowed_bad']:.1f}; "
          f"remaining {budget['remaining_frac']:+.1%})")
    print(f"p99 turnaround: naive {p99_naive:.2f}s -> "
          f"controlled {p99_ctrl:.2f}s")

    # The controlled run's span tree, ring-limited to the last 100 jobs,
    # with the control decisions as a Chrome "slo control" track.
    rec = SpanRecorder(max_jobs=100)
    rec.record(result, control_log=controller.log)
    if rec.check() != []:
        raise AssertionError("span tiling violated")
    path = args.trace_out
    rec.save_chrome(path)
    print(f"\nwrote Chrome trace (open in ui.perfetto.dev): {path}")
    print(f"  retained jobs: 100 of {100 + rec.n_dropped_jobs} "
          f"completed; dropped {rec.n_dropped_jobs} jobs / "
          f"{rec.n_dropped_spans} spans from the ring")
    return {"p99_naive": p99_naive, "p99_controlled": p99_ctrl,
            "decisions": list(controller.log), "alarms": list(monitor.alarms),
            "budget": budget}


if __name__ == "__main__":
    main()
