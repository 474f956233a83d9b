"""Where does a MapReduce job's time go?  Per-phase telemetry walkthrough
(counterpart of ``examples/phase_breakdown.py``).

Runs WordCount and Exim parsing at a few (M, R) settings through the
engine's traced mode (reduce backend ``cuda``), prints a per-phase
time/bytes table, then fits the decomposed per-phase models next to the
paper's monolithic one and shows both predictions at an unseen setting.

    PYTHONPATH=src python -m repro_torch.phase_breakdown            # on the card
    PYTHONPATH=src python -m repro_torch.phase_breakdown --device cpu [--tokens N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import fit
from repro_torch.device import resolve_device
from repro_torch.mapreduce import JobConfig, build_job
from repro_torch.runner import make_app
from repro_torch.telemetry import (
    TIME_RESOURCE,
    PhaseRecorder,
    collect_traced,
    fit_phase_models,
    targets_from_traces,
)

#: enough settings to determine the paper's cubic 2-param basis (7 coefs).
CONFIGS = [(5, 5), (5, 20), (12, 12), (20, 5), (20, 20), (28, 28),
           (36, 12), (40, 40)]
UNSEEN = (17, 9)


class TracedRunner:
    """Cached traced runs: trace(M, R) -> JobTrace for one app."""

    def __init__(self, app, corpus, device):
        self.app = app
        self.corpus = corpus
        self.device = device
        self.recorder = PhaseRecorder()
        self._jobs: dict = {}

    def __call__(self, config):
        M, R = int(config[0]), int(config[1])
        if (M, R) not in self._jobs:
            job = build_job(
                self.app,
                JobConfig(num_mappers=M, num_reducers=R, capacity_factor=8.0,
                          reduce_backend="cuda"),
                len(self.corpus), recorder=self.recorder, device=self.device,
            )
            job(self.corpus)
            self.recorder.traces.pop()  # the warmup is not telemetry
            self._jobs[(M, R)] = job
        out_keys, out_vals, _ = self._jobs[(M, R)](self.corpus)
        trace = self.recorder.last
        collect_traced(trace, out_keys, out_vals)
        return trace


def profile_phases(runner, configs, repeats):
    params = np.asarray(configs, dtype=np.float64)
    return params, [[runner(row) for _ in range(repeats)] for row in configs]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tokens", type=int, default=1 << 13)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    report = {}
    for app_name in ("wordcount", "eximparse"):
        app, corpus = make_app(app_name, args.tokens)
        corpus = torch.as_tensor(corpus, device=dev)
        print(f"\n=== {app_name} ({args.tokens} tokens, {dev.type}) ===")
        runner = TracedRunner(app, corpus, dev)
        params, traces = profile_phases(runner, CONFIGS, args.repeats)
        targets = targets_from_traces(traces)
        phase_names = traces[0][0].phase_names()

        print(f"{'M':>4} {'R':>4} | "
              + " ".join(f"{p:>10}" for p in phase_names)
              + f" | {'total':>9} {'shuf KiB':>9} {'dropped':>8}")
        for i, (m, r) in enumerate(params):
            times = [targets[(p, TIME_RESOURCE)][i] for p in phase_names]
            shuf_kib = targets[("shuffle", "bytes_out")][i] / 1024
            dropped = traces[i][0].counter("shuffle", "pairs_dropped")
            print(f"{int(m):>4} {int(r):>4} | "
                  + " ".join(f"{t * 1e3:>8.2f}ms" for t in times)
                  + f" | {sum(times) * 1e3:>7.2f}ms {shuf_kib:>9.1f}"
                  f" {int(dropped):>8}")

        phase_models = fit_phase_models(params, targets, device=dev)
        totals = np.sum(
            [targets[(p, TIME_RESOURCE)] for p in phase_names], axis=0
        )
        monolithic = fit(params, totals, device=dev)

        trace = runner(UNSEEN)
        actual = trace.phase_time_sum()
        unseen = np.asarray(UNSEEN, float)
        composed = float(phase_models.predict_total(unseen, device=dev)[0])
        mono = float(np.asarray(
            monolithic.predict(unseen, device=dev).cpu()).ravel()[0])
        print(f"\nunseen (M, R) = {UNSEEN}:")
        print(f"  actual            {actual * 1e3:8.2f}ms")
        print(f"  composed (sum of phase models) "
              f"{composed * 1e3:8.2f}ms  "
              f"err {abs(composed - actual) / actual * 100:5.1f}%")
        print(f"  monolithic (paper)             "
              f"{mono * 1e3:8.2f}ms  "
              f"err {abs(mono - actual) / actual * 100:5.1f}%")
        per_phase = phase_models.predict_phase_times(unseen, device=dev)
        breakdown = ", ".join(
            f"{p}={float(v[0]) * 1e3:.2f}ms" for p, v in per_phase.items()
        )
        print(f"  composed breakdown: {breakdown}")
        report[app_name] = {"traces": traces, "targets": targets, "actual": actual,
                            "composed": composed, "monolithic": mono}
    return report


if __name__ == "__main__":
    main()
