"""Run the port's MapReduce engine end to end: WordCount over a Zipf
corpus through one ExecutionPlan whose mode the flags pick (counterpart of
``examples/mapreduce_wordcount.py``) — fused by default, the sharded
all-to-all mode on a world of W rank processes with ``--workers W``, the
pipelined wave schedule with ``--depth 2+``, and the phase-fenced traced
mode (per-phase wall times, on any path) with ``--phase-times``.  The
engine reduces with the hand-written CUDA kernels
(``reduce_backend="cuda"``; their plain versions on the CPU).

    PYTHONPATH=src python -m repro_torch.mapreduce_wordcount          # on the card
    PYTHONPATH=src python -m repro_torch.mapreduce_wordcount --device cpu
    # per-phase wall times (works on the sharded path too):
    PYTHONPATH=src python -m repro_torch.mapreduce_wordcount --phase-times
    # pipelined wave schedule (bit-exact vs fused):
    PYTHONPATH=src python -m repro_torch.mapreduce_wordcount --depth 4
    # map-side combining, with the combine phase's counters:
    PYTHONPATH=src python -m repro_torch.mapreduce_wordcount --combiner --phase-times
    # multi-worker shuffle: one rank a card (NCCL), or gloo ranks on the CPU
    PYTHONPATH=src python -m repro_torch.mapreduce_wordcount --workers 4 --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.mapreduce import (
    ExecutionPlan,
    JobConfig,
    collect_results,
    wordcount,
    wordcount_corpus,
)
from repro_torch.telemetry import PhaseRecorder


def _run_ranks(args, dev, cfg):
    """The sharded job on a world of ``args.workers`` rank processes:
    (out_keys, out_vals, dropped, wall, trace)."""
    from repro_torch.mapreduce.ranks import RankRequest, RankWorld

    with RankWorld(args.workers, dev) as world:
        reply = world.run(RankRequest(
            "wordcount", args.tokens, cfg.reduce_backend, cfg.num_mappers,
            cfg.num_reducers, combiner=args.combiner, traced=args.phase_times,
            outputs=True,
        ))
    ok, ov, dropped = reply.outputs
    return torch.as_tensor(ok), torch.as_tensor(ov), dropped, reply.wall_s, reply.trace


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tokens", type=int, default=1 << 16)
    ap.add_argument("--mappers", type=int, default=20)
    ap.add_argument("--reducers", type=int, default=5)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--depth", type=int, default=1,
                    help="overlap depth: group this many waves per "
                         "software-pipeline step (1 = serial fused)")
    ap.add_argument("--combiner", action="store_true",
                    help="map-side combine: pre-aggregate each map task's "
                         "pairs before the shuffle (bit-exact for "
                         "WordCount's sum; contracts shuffle bytes)")
    ap.add_argument("--phase-times", action="store_true",
                    help="run the traced mode: fence and wall-clock each "
                         "phase (on every rank when sharded)")
    args = ap.parse_args(argv)
    if args.depth > 1 and args.workers > 1:
        ap.error("--depth > 1 is a single-controller schedule; "
                 "it does not compose with --workers > 1")
    dev = resolve_device(args.device)
    cfg = JobConfig(
        num_mappers=args.mappers, num_reducers=args.reducers,
        num_workers=args.workers, overlap_depth=args.depth,
        combiner=args.combiner, reduce_backend="cuda",
    )
    if args.workers > 1:
        ok, ov, dropped, dt, trace = _run_ranks(args, dev, cfg)
        path = f"sharded all_to_all over {args.workers} rank processes"
    else:
        corpus = torch.as_tensor(
            wordcount_corpus(args.tokens, vocab_size=4096, seed=0), device=dev)
        recorder = PhaseRecorder() if args.phase_times else None
        plan = ExecutionPlan(wordcount(4096), cfg, len(corpus), device=dev)
        if recorder is not None:
            job = plan.traced(recorder)  # picks up cfg.overlap_depth
            path = "single-controller (traced)"
            if args.depth > 1:
                path += f", pipelined depth={args.depth}"
        elif args.depth > 1:
            job = plan.pipelined()
            path = f"single-controller (pipelined, depth={args.depth})"
        else:
            job = plan.fused()
            path = "single-controller (fused)"

        def fence():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        job(corpus)  # job setup (the kernels' first build on the card)
        fence()
        t0 = time.perf_counter()
        ok, ov, dropped = job(corpus)
        fence()
        dt = time.perf_counter() - t0
        trace = None if recorder is None else recorder.last
    counts = collect_results(ok, ov)
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:10]
    if args.combiner:
        path += ", combiner on"
    print(f"{args.tokens} tokens, M={cfg.num_mappers} R={cfg.num_reducers} "
          f"({cfg.map_waves}/{cfg.reduce_waves} waves), {path}, on {dev.type}")
    print(f"execution time: {dt * 1e3:.1f}ms; dropped={int(dropped)}")
    times = None
    if trace is not None:
        times = trace.phase_times()
        print("phase walls: " + ", ".join(
            f"{k}={v * 1e3:.1f}ms" for k, v in times.items()))
    print("top words:", top)
    if sum(counts.values()) != args.tokens:
        raise AssertionError(f"counted {sum(counts.values())} of {args.tokens} tokens")
    return {"counts": counts, "dropped": int(dropped), "wall_s": dt, "phase_times": times}


if __name__ == "__main__":
    main()
