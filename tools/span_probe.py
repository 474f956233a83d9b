"""Where a fused job's device time goes, by the program's own spans.

For each cell it makes the corpus from the seed and builds and warms the
cell's jobs as ``portbench/run.py`` does, then profiles ``--rounds``
rounds of the mix's fused jobs under ``torch.profiler`` (CPU and CUDA),
``--repeat`` times, as the benchmark's ``--trace 1`` run profiles them.
From each profile it reads what the program's ``record_function`` spans
give (``portbench/spans.py``): device ms a job by span, device operations
launched a job, device-idle time inside the jobs' host spans, the longest
idle gaps named by their enclosing span, and the device operations of each
span by kernel name; and the host wall a job of the profiled rounds.

    python3 tools/span_probe.py --workload wc-fixed,wc-combine,exim-sweep \\
        --seed 7 [--repeat 3] [--rounds N] [--src OTHER/src] [--tokens N] \\
        [--device cuda] [--out chiprun_out/span_probe.jsonl]

``--src`` runs another checkout's program under the same procedure (its
readings are None where it opens no spans), to compare what tracing costs.
One JSON line a (cell, repeat) on standard output and appended to
``--out``.  Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PHASES = ("mapreduce.map", "mapreduce.combine", "mapreduce.shuffle", "mapreduce.reduce")
STEPS = ("mapreduce.shuffle.sort", "mapreduce.shuffle.gather", "mapreduce.shuffle.scatter")


def ops_by_span(box, jobs: int, top: int = 6) -> dict:
    """Device ms a job by (innermost program span, kernel name), the
    ``top`` largest kernels of each span; "outside" for kernels launched
    outside every span."""
    from portbench.spans import launches_by_span

    table: dict = {}
    for above, kernels in launches_by_span(box["prof"].events()):
        row = table.setdefault(above[0] if above else "outside", {})
        for k in kernels:
            row[k.name[:80]] = row.get(k.name[:80], 0.0) + k.duration / 1e3 / jobs
    return {s: sorted(([n, v] for n, v in row.items()), key=lambda kv: -kv[1])[:top]
            for s, row in table.items()}


def gap_hosts(box, top: int = 3, most: int = 8) -> list:
    """For each of the ``top`` longest device-idle gaps: its length (ms),
    the device operations that end it and follow it, and the host events
    that overlap it, as [name, start and end (ms from the gap's start)],
    in order."""
    from torch.autograd import DeviceType

    from portbench.profiling import _device_events
    from portbench.spans import longest_gaps

    events = box["prof"].events()
    dev = _device_events(events)
    host = [e for e in events if e.device_type == DeviceType.CPU and not e.is_async]
    out = []
    for length, a, b in longest_gaps(events, top):
        before = max((e for e in dev if e.time_range.end <= a),
                     key=lambda e: e.time_range.end, default=None)
        after = min((e for e in dev if e.time_range.start >= b),
                    key=lambda e: e.time_range.start, default=None)
        inside = sorted((e for e in host if e.time_range.start < b and e.time_range.end > a),
                        key=lambda e: e.time_range.start)
        out.append([length / 1e3, before and before.name[:60], after and after.name[:60],
                    [[e.name[:40], (e.time_range.start - a) / 1e3,
                      (e.time_range.end - a) / 1e3] for e in inside[-most:]]])
    return out


def probe(cell, seed: int, args) -> list[dict]:
    import torch

    from portbench import gen, harness, profiling, spans
    from repro_torch.mapreduce import build_job

    tokens = int(cell.config["tokens"] if args.tokens is None else args.tokens)
    harness.kernels_ready(args.device)
    corpus = gen.corpus(cell.config, seed, args.device, tokens)
    mix = cell.jobs()
    app = cell.app(tokens)
    jobs = [build_job(app, m.job_config(), tokens, device=args.device) for m in mix]
    harness.run_rounds(jobs, corpus, args.device, int(cell.traffic.get("warmup_rounds", 1)))
    rounds = args.rounds or int(cell.traffic.get("trace_rounds", 1))
    dev = torch.device(args.device)
    lines = []
    for rep in range(args.repeat):
        with profiling.traced(args.device) as box:
            harness.run_rounds(jobs, corpus, args.device, rounds)
        n_jobs = rounds * len(mix)
        summary = profiling.summary(box)
        rec = {**spans.records(box), "window_s": summary["window_s"]}
        readings = {m: spans.read(m, rec) for m in spans.METRICS}
        span_ms = {s: spans.device_ms(rec, s) for s in spans.SPANS}
        phases = sum(span_ms[s] or 0.0 for s in PHASES)
        steps = sum(span_ms[s] or 0.0 for s in STEPS)
        op_ms = 1e3 * rec["device_op_s"] / n_jobs
        lines.append({
            "cell": cell.name, "seed": seed, "repeat": rep, "tokens": tokens,
            "src": str(Path(sys.modules["repro_torch"].__file__).parents[1]),
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
            "power_limit": harness.power_limit() if dev.type == "cuda" else None,
            "jobs": n_jobs,
            "wall_ms_a_job": 1e3 * summary["window_s"] / n_jobs,
            "idle_pct": 100.0 * (1.0 - summary["busy_s"] / summary["window_s"]),
            "readings": readings,
            "span_ms": {s: v for s, v in span_ms.items() if v is not None},
            "span_n_a_job": {s: n / n_jobs for s, n in rec["span_n"].items() if n},
            "device_op_ms_a_job": op_ms,
            "phases_share": phases / op_ms if op_ms else None,
            "steps_share_of_shuffle": (steps / span_ms["mapreduce.shuffle"]
                                       if span_ms["mapreduce.shuffle"] else None),
            "device_ops_a_job": len(profiling._device_events(box["prof"].events())) / n_jobs,
            "idle_gaps": spans.idle_gaps(box),
            "ops_by_span": ops_by_span(box, n_jobs),
            "gap_hosts": gap_hosts(box),
        })
        del box
    del jobs, corpus
    harness.free(args.device)
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--repeat", type=int, default=1)
    parser.add_argument("--rounds", type=int, default=None)
    parser.add_argument("--tokens", type=int, default=None)
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]

    from portbench.spec import load_cell

    for name in args.workload.split(","):
        t0 = time.perf_counter()
        for line in probe(load_cell(name), args.seed, args):
            line["process_s"] = time.perf_counter() - t0
            text = json.dumps(line)
            print(text, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
