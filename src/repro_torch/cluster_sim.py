"""Walkthrough: the paper's models driving a multi-job cluster scheduler
(counterpart of ``examples/cluster_sim.py``).

The paper motivates its config→time models with *smarter job scheduling*.
This example closes that loop end to end:

1. generate a deterministic heterogeneous trace (WordCount + EximParse
   jobs, Poisson arrivals, log-uniform sizes, some with SLO deadlines);
2. run the static-config FIFO baseline — the scheduler the paper argues
   real clusters settle for;
3. run the prediction-driven policies: each job's (backend, M, R,
   worker-grant) comes from the fitted per-(app, backend) models in a
   shared ModelDatabase, and shortest-predicted-first / deadline admission
   use the predicted time *before* dispatch;
4. watch online refinement shrink prediction error as completed jobs are
   fed back into the models (the profiling phase made continuous);
5. persist the model database, as a long-lived scheduler would.

    PYTHONPATH=src python -m repro_torch.cluster_sim          # analytic oracle
    PYTHONPATH=src python -m repro_torch.cluster_sim --real   # tiny trace on the
                                                 # live engine, on the card
    PYTHONPATH=src python -m repro_torch.cluster_sim --real --device cpu

With ``--real`` the baseline reduces with the ``cuda`` backend (the
hand-written kernels on the card) and the predictive policies choose
between ``torch`` and ``cuda``.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

from repro_torch.cluster import (
    AnalyticOracle,
    Cluster,
    EngineOracle,
    assign_deadlines,
    generate_workload,
    get_policy,
)
from repro_torch.core.predictor import ModelDatabase


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--real", action="store_true",
                    help="wall-clock the live MapReduce engine (tiny trace)")
    ap.add_argument("--device", default="cuda",
                    help="device of the live engine (with --real)")
    args = ap.parse_args(argv)

    # --- the cluster and its workload --------------------------------------
    fifo_kw: dict = {}
    if args.real:
        oracle = EngineOracle(device=args.device)
        jobs = generate_workload(6, seed=7, mean_interarrival=0.05,
                                 size_range=(1 << 11, 1 << 13))
        workers, grids = 4, dict(mapper_grid=(2, 4, 8), reducer_grid=(2, 4, 8),
                                 worker_grid=(2, 4),
                                 bootstrap_sizes=(1 << 11, 1 << 13),
                                 backends=("torch", "cuda"))
        fifo_kw = {"backend": "cuda"}
    else:
        oracle = AnalyticOracle(noise=0.02, seed=7)
        jobs = generate_workload(60, seed=7, mean_interarrival=0.12,
                                 size_range=(1 << 14, 1 << 18))
        workers, grids = 16, {}
    jobs = assign_deadlines(jobs, lambda j: oracle.nominal_time(j.app, j.size),
                            slack_range=(1.2, 6.0), fraction=0.6, seed=8)
    cluster = Cluster(workers, oracle)
    print(f"trace: {len(jobs)} jobs on {workers} workers "
          f"({sum(1 for j in jobs if j.deadline is not None)} with deadlines), "
          f"oracle={oracle.platform}")

    # --- baseline: FIFO with one static config -----------------------------
    fifo = cluster.run(jobs, get_policy("fifo-static", **fifo_kw))
    mb = fifo.metrics()
    metrics = {"fifo-static": mb}
    print(f"\nfifo-static      : makespan {mb['makespan_s']:7.2f}s  "
          f"mean wait {mb['mean_wait_s']:5.2f}s  SLO {mb['slo_attainment']}")

    # --- prediction-driven scheduling --------------------------------------
    for name in ("predict-sjf", "predict-deadline"):
        policy = get_policy(name, seed=7, **grids)
        result = cluster.run(jobs, policy)
        m = metrics[name] = result.metrics()
        print(f"{name:<17}: makespan {m['makespan_s']:7.2f}s  "
              f"mean wait {m['mean_wait_s']:5.2f}s  SLO {m['slo_attainment']}  "
              f"rejected {m['n_rejected']}")
        trend = ("shrinking" if m["pred_mae_pct_second_half"]
                 < m["pred_mae_pct_first_half"] else "dominated by run noise")
        print(f"                   prediction MAE "
              f"{m['pred_mae_pct_first_half']:.1f}% (first half of trace) -> "
              f"{m['pred_mae_pct_second_half']:.1f}% (second half; online "
              f"refinement: {trend})")
        speedup = mb["makespan_s"] / m["makespan_s"]
        print(f"                   {speedup:.2f}x the baseline's makespan")

    # --- the model database persists, like a real scheduler's would --------
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "models.json"
        policy.db.save(str(path))
        reloaded = ModelDatabase.load(str(path))
        keys = policy.db.applications()
        if reloaded.applications() != keys or any(
                reloaded.get(*k).to_dict() != policy.db.get(*k).to_dict() for k in keys):
            raise AssertionError("the model database changed in its round trip")
    print(f"\nmodel database: {len(reloaded)} fitted (app, platform, backend) "
          f"models round-tripped through a JSON file")
    print("stored keys:", *reloaded.applications(), sep="\n  ")
    return metrics


if __name__ == "__main__":
    main()
