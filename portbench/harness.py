"""One run of a cell: set-up, the measured window, the traced extras, the
check against the reference, and the result line.

:func:`run_local` runs a cell.  The window is a closed loop: one job at a
time, each from its call to the fence that ends its device work, the next
started when the last has ended.  The outputs the check samples are read
back between jobs, and that time is not the window's.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time

import numpy as np
import torch

from portbench import gen, profiling
from portbench.reference import PAD_KEY, Output, expected, mismatches
from portbench.spec import HERE, Cell

ROOT = HERE.parent
#: modules that may not be loaded in a process that prints a result
FOREIGN = ("jax", "jaxlib", "flax", "repro")
#: phases of the program's plan, as its phase functions name them
PHASES = ("map", "combine", "shuffle", "reduce")


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FOREIGN``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def kernels_ready(device) -> float:
    """Build (once per checkout) and load the program's kernel library.
    Returns the seconds a cold build took, 0 when it was already built."""
    if torch.device(device).type != "cuda":
        return 0.0
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _, log = _build.build()
    _build.load()
    return time.perf_counter() - t0 if log else 0.0


def read_output(out) -> Output:
    """A job's ``(out_keys, out_vals, dropped)`` as the check reads it: the
    live slots, the dead slots holding a value, the dropped count."""
    ok, ov, dropped = out[0], out[1], out[2]
    rows, cols = ok.shape
    ok, ov = ok.reshape(-1), ov.reshape(-1)
    live = ok != PAD_KEY
    idx = live.nonzero().squeeze(1)
    dead_nonzero = int(((ov != 0) & ~live).sum())
    return Output(rows=rows, cols=cols, pos=idx.cpu().numpy(),
                  keys=ok[idx].cpu().numpy(), vals=ov[idx].cpu().numpy(),
                  dropped=int(dropped), dead_nonzero=dead_nonzero)


def run_rounds(jobs, corpus, device, rounds: int) -> None:
    """Every job ``rounds`` times, one at a time, each to its fence."""
    for _ in range(rounds):
        for job in jobs:
            out = job(corpus)
            sync(device)
            del out


@dataclasses.dataclass
class Window:
    """What the measured window saw."""

    walls: list            # each job's seconds, call to fence
    enqueue: list          # each job's seconds, call to return
    begin: float
    end: float             # the last job's fence
    outputs: list          # (job index, job's place in the mix, Output)
    first_job_wall: float  # time.time() at the first job's call
    readback: float        # seconds spent reading outputs back before ``end``

    @property
    def seconds(self) -> float:
        """The window's seconds of job work: from its start to the last
        job's fence, less the read-backs between jobs."""
        return self.end - self.begin - self.readback


def checked(seed: int, every: int):
    """Which jobs of the window the check reads: every ``every``-th from
    an offset drawn from the seed, and the last."""
    offset = int(np.random.default_rng(seed).integers(every))
    return lambda i, last: last or i % every == offset


def closed_loop(call, n_mix: int, seconds: float, device, keep) -> Window:
    """Jobs ``call(i % n_mix)`` one at a time for ``seconds``.  ``keep(i,
    last)`` says which outputs to read back."""
    walls, enqueue, outputs = [], [], []
    begin = time.perf_counter()
    deadline = begin + seconds
    end, first, readback, pending = begin, None, 0.0, 0.0
    i = 0
    while time.perf_counter() < deadline:
        if first is None:
            first = time.time()
        # a read-back lies inside the window only when a job follows it
        readback, pending = readback + pending, 0.0
        t0 = time.perf_counter()
        out = call(i % n_mix)
        t1 = time.perf_counter()
        sync(device)
        end = time.perf_counter()
        walls.append(end - t0)
        enqueue.append(t1 - t0)
        if keep(i, end >= deadline):
            r0 = time.perf_counter()
            outputs.append((i, i % n_mix, read_output(out)))
            pending = time.perf_counter() - r0
        del out
        i += 1
    return Window(walls, enqueue, begin, end, outputs, first or time.time(), readback)


def end_to_end(window: Window, tokens: int, setup_s: float) -> dict:
    return {
        "tokens_per_s": tokens * len(window.walls) / window.seconds,
        "job_ms_p95": float(np.percentile(np.asarray(window.walls) * 1e3, 95)),
        "setup_s": setup_s,
    }


def check(cell: Cell, mix, corpus, outputs, tokens: int) -> tuple[int, int]:
    """(slots that differ, jobs that differ) over the read-back outputs."""
    wrong = bad_jobs = 0
    for place in sorted({p for _, p, _ in outputs}):
        want = expected(corpus, cell.shape(mix[place], tokens))
        for _, p, got in outputs:
            if p == place:
                n = mismatches(want, got)
                wrong += n
                bad_jobs += n > 0
    return wrong, bad_jobs


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def device_info(device, count: int, peak: int) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count, "memory_peak_bytes": peak}


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().replace("\n", "; ") or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def peak_bytes_per_s(device) -> float | None:
    """The card's published memory bandwidth, from ``peaks.json``."""
    if torch.device(device).type != "cuda":
        return None
    peaks = json.loads((HERE / "peaks.json").read_text())
    entry = peaks.get(torch.cuda.get_device_name(torch.device(device)))
    return None if entry is None else float(entry["hbm_bytes_per_s"])


def metrics_for(cell: Cell, trace: bool) -> list[dict]:
    """The metrics ``BENCHMARK.json`` asks of this cell in this kind of run."""
    bench = benchmark()
    pool = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in pool if cell.name in m.get("workloads", [cell.name])]


def read_layer(name: str, records: dict):
    """``portbench/metrics/<name>.py``'s reading of the traced records."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(records)


def result(cell: Cell, values: dict, trace: bool, correct: bool, attempted: int,
           failed: int, device: dict, wrong: int, breakdown=None) -> dict:
    metrics = {}
    for m in metrics_for(cell, trace):
        v = values.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {"mismatched_slots": {"value": wrong, "limit": 0}}
    return line


def layer_values(cell: Cell, records: dict) -> dict:
    return {m["name"]: read_layer(m["name"], records)
            for m in metrics_for(cell, trace=True)}


def fit_error(cell: Cell, mix, window: Window):
    """The held-out error of the paper's regression fitted on the mix's
    training jobs' mean walls, when the mix names both sets."""
    fit = cell.traffic.get("fit")
    if not fit:
        return None
    from repro_torch.core import fit as fit_model, prediction_error_stats

    walls = np.asarray(window.walls)
    place = np.arange(len(walls)) % len(mix)

    def table(lo, hi):
        rows = [(i, walls[place == i]) for i in range(lo, hi)]
        rows = [(i, w) for i, w in rows if len(w)]
        params = np.asarray([[mix[i].mappers, mix[i].reducers] for i, _ in rows], float)
        return params, np.asarray([w.mean() for _, w in rows])

    train_p, train_t = table(*fit["train"])
    held_p, held_t = table(*fit["heldout"])
    if len(train_p) < 10 or not len(held_p):
        return None
    model = fit_model(train_p, train_t, device="cpu")
    return prediction_error_stats(model, held_p, held_t, device="cpu")


def trace_extras(cell: Cell, mix, jobs, corpus, device, tokens: int) -> dict:
    """The traced run's records: fused jobs under the profiler, the traced
    mode's phase walls and counters, and each phase of the plan in a
    ``record_function`` range under the profiler."""
    from repro_torch.mapreduce import ExecutionPlan, build_job
    from repro_torch.telemetry import PhaseRecorder

    rounds = int(cell.traffic.get("trace_rounds", 1))
    app = cell.app(tokens)
    with profiling.traced(device) as fused_box:
        run_rounds(jobs, corpus, device, rounds)
    recorder = PhaseRecorder()
    for m in mix:
        traced_job = build_job(app, m.job_config(), tokens, recorder=recorder,
                               device=device)
        for _ in range(rounds):
            out = traced_job(corpus)
            del out
    fns = [ExecutionPlan(app, m.job_config(), tokens, device=device).phase_fns()
           for m in mix]
    names = [f"portbench.{p}" for p in PHASES]
    with profiling.traced(device) as phase_box:
        for _ in range(rounds):
            for f in fns:
                with torch.profiler.record_function("portbench.map"):
                    bufs = f["map"](corpus)
                if "combine" in f:
                    with torch.profiler.record_function("portbench.combine"):
                        bufs = f["combine"](*bufs)
                with torch.profiler.record_function("portbench.shuffle"):
                    pk, pv, _ = f["shuffle"](*bufs)
                del bufs
                with torch.profiler.record_function("portbench.reduce"):
                    out = f["reduce"](pk, pv)
                del pk, pv, out
                sync(device)
    summary = profiling.summary(fused_box)
    return {
        "traces": [t.to_dict() for t in recorder.traces],
        "range_s": profiling.range_device_s(phase_box, names),
        "bytes_per_s": peak_bytes_per_s(device),
        "busy_s": summary["busy_s"],
        "window_s": summary["window_s"],
        "breakdown": {"device_ops": summary["device_ops"],
                      "idle_gaps": summary["idle_gaps"]},
    }


def run_local(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
              device="cuda", tokens: int | None = None, hook=None):
    """One run of a cell.  Returns (result line, lines for standard error,
    the checked numbers last)."""
    from repro_torch.mapreduce import build_job

    tokens = int(cell.config["tokens"] if tokens is None else tokens)
    log = []
    cold = kernels_ready(device)
    corpus = gen.corpus(cell.config, seed, device, tokens)
    if hook is not None:
        hook()
    mix = cell.jobs()
    app = cell.app(tokens)
    jobs = [build_job(app, m.job_config(), tokens, device=device) for m in mix]
    run_rounds(jobs, corpus, device, int(cell.traffic.get("warmup_rounds", 1)))
    window = closed_loop(lambda i: jobs[i](corpus), len(mix), seconds, device,
                         checked(seed, int(cell.traffic["check_every"])))
    setup_s = window.first_job_wall - t_start
    peak = memory_peak(device)
    records = {"enqueue_s": window.enqueue}
    breakdown = None
    if trace:
        records.update(trace_extras(cell, mix, jobs, corpus, device, tokens))
        breakdown = records.pop("breakdown")
    del jobs
    free(device)
    wrong, bad_jobs = check(cell, mix, corpus, window.outputs, tokens)
    err = fit_error(cell, mix, window)

    log.append(f"portbench: {cell.name} seed {seed}: {len(window.walls)} jobs in "
               f"{window.seconds:.3f} s (read-backs {window.readback:.3f} s apart); "
               "kernel library "
               + (f"built cold in {cold:.1f} s" if cold else "already built"))
    log.append(f"info memory_peak_gib {peak / 2**30:.3f}")
    if err is not None:
        log.append(f"info heldout_error_pct mean {err['mean_pct']:.3f} "
                   f"max {err['max_pct']:.3f}")
    values = end_to_end(window, tokens, setup_s)
    if trace:
        log.append(f"info power_limit {power_limit()} (rooflines against "
                   f"{records['bytes_per_s']} B/s)")
        values = layer_values(cell, records)
        dev = device_info(device, 1, peak)
        dev.update(busy_s=records["busy_s"], window_s=records["window_s"])
    else:
        dev = device_info(device, 1, peak)
    log.append(f"info jobs_checked {len(window.outputs)} jobs_wrong {bad_jobs}")
    log.append(f"check mismatched_slots {wrong} limit 0")
    line = result(cell, values, trace, wrong == 0 and len(window.outputs) > 0,
                  len(window.walls), bad_jobs, dev, wrong, breakdown)
    return line, log
