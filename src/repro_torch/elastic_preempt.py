"""Elastic execution walkthrough: preempt, snapshot, regrant, resume
(counterpart of ``examples/elastic_preempt.py``).

    PYTHONPATH=src python -m repro_torch.elastic_preempt            # on the card
    PYTHONPATH=src python -m repro_torch.elastic_preempt --device cpu

Runs a WordCount job through the wave-steppable engine (reduce backend
``cuda``), preempts it mid-map, persists the wave-boundary snapshot
through the checkpoint manager, restores it template-free ("a different
process"), *regrants* the job from 2 workers to 4, resumes — and verifies
the result is bit-identical to the uninterrupted 2-worker run.  Then
prices the regrant with the cost model the ``predict-elastic`` scheduler
uses.
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.cluster import AnalyticOracle
from repro_torch.device import resolve_device
from repro_torch.elastic import (
    RegrantCostModel,
    ResumableJob,
    load_snapshot,
    run_resumable,
    save_snapshot,
)
from repro_torch.mapreduce import JobConfig, collect_results, wordcount, \
    wordcount_corpus


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    corpus = torch.as_tensor(wordcount_corpus(6000, vocab_size=211, seed=1), device=dev)
    app = wordcount(211)
    cfg = JobConfig(num_mappers=8, num_reducers=4, num_workers=2,
                    capacity_factor=8.0, reduce_backend="cuda")
    # ResumableJob is the resumable *mode* of the one ExecutionPlan the
    # fused/traced/sharded paths also run, so the wave-stepped results
    # below are bit-exact vs build_job by construction.
    job = ResumableJob(app, cfg, len(corpus), device=dev)

    # Reference: the uninterrupted run.
    ref = run_resumable(job, corpus)
    ok0, ov0, d0 = job.result(ref)
    print(f"[elastic] uninterrupted: {ref.cursor.waves_executed} "
          f"wave-boundary steps, dropped={int(d0)}")

    # Preempt after 2 map waves, snapshot through the checkpoint manager.
    state = run_resumable(job, corpus, preempt_after=2)
    c = state.cursor
    print(f"[elastic] preempted at boundary: map {c.map_tasks_done}/"
          f"{c.mappers} tasks done, shuffled={c.shuffled}")
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=3)
        step, save_s = save_snapshot(mgr, state)
        restored, _, restore_s = load_snapshot(mgr, device=dev)  # template-free
        print(f"[elastic] snapshot step {step}: save {save_s * 1e3:.1f}ms,"
              f" restore {restore_s * 1e3:.1f}ms")

    # Re-plan the remaining waves under twice the workers and resume.
    restored = job.regrant(restored, 4)
    done = run_resumable(job, corpus, state=restored)
    ok1, ov1, d1 = job.result(done)
    if not (torch.equal(ok0, ok1) and torch.equal(ov0, ov1) and int(d0) == int(d1)
            and collect_results(ok1, ov1) == collect_results(ok0, ov0)):
        raise AssertionError("the regranted run differs from the uninterrupted one")
    print("[elastic] resumed under W=4: bit-identical to the W=2 run")

    # Price the same regrant the way the scheduler would: predicted
    # remaining time under each grant + the measured checkpoint cost.
    oracle = AnalyticOracle(noise=0.0)
    cost = RegrantCostModel()
    cost.record_overhead(save_s, restore_s)
    decision = cost.evaluate(
        t_total_current=oracle.time("wordcount", "torch", len(corpus),
                                    c.mappers, c.reducers, 2),
        t_total_new=oracle.time("wordcount", "torch", len(corpus),
                                c.mappers, c.reducers, 4),
        progress=c.progress(), current_workers=2, new_workers=4,
    )
    print(f"[elastic] regrant 2->4: remaining {decision.t_remaining_current:.3f}s"
          f" -> {decision.t_remaining_new:.3f}s + overhead "
          f"{decision.overhead_s * 1e3:.1f}ms, gain {decision.gain_s:+.3f}s,"
          f" worth_it={decision.worth_it}")
    return {"cursor": c, "save_s": save_s, "restore_s": restore_s, "decision": decision,
            "counts": collect_results(ok1, ov1)}


if __name__ == "__main__":
    main()
