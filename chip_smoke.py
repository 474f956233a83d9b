#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one or more printed lines each:

1. build: compile the hand-written kernels from ``src/repro_torch/csrc``;
2. kernels: hold each kernel against its plain PyTorch version on the card,
   bit for bit, at the main path's shapes and on edge rows (all-PAD, one
   key, a run across many tiles, sums above 2**24), with its time, the
   plain version's time and its memory bound;
3. engine: both applications at 2**26 tokens through ``build_job`` with the
   ``"cuda"`` and ``"torch"`` reduce backends at a few (M, R, W): outputs
   bit-identical, results equal to a numpy count of the corpus, and
   WordCount's combiner run equal to the run without it;
4. loop: the paper's profile -> fit -> predict loop per application, 20
   training and 8 held-out (M, R) settings, reduce backend ``"cuda"``;
5. launches: the kernel launch counts of phases 3-4 (the main path), which
   must be exactly one ``segment_reduce`` per reduce wave and one
   ``local_reduce`` per combiner job;
6. breakdown: where one full-size job's time goes, phase by phase and (under
   ``torch.profiler``) kernel by kernel, with the device's busy share.

Then a ``kernels`` JSON line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; so does a machine without a CUDA device, or a copy of this file
outside the repository.  Nothing here imports JAX or the reference package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOKENS = 1 << 26
#: the paper takes the mean of 5 runs per setting
REPEATS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
#: (M, R, W) settings of the engine phase; 7 % 2 and 37 % 4 leave partial
#: final waves, which the steppers must clamp like the reference
ENGINE_CONFIGS = ((20, 5, 1), (7, 3, 2), (37, 40, 4))
PATH_R, PATH_M = 5, 20  # shapes reported in the kernels line


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def device_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean time of ``fn()`` on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sorted_rows(n_rows: int, n_cols: int, *, key_space: int, fill: float,
                seed: int):
    """Random key-sorted int32 rows with a PAD_KEY tail, like a partition:
    ``fill`` of the slots live, values in [200, 4000)."""
    from repro_torch.mapreduce.phases import PAD_KEY

    g = torch.Generator(device="cuda").manual_seed(seed)
    live = max(1, int(n_cols * fill))
    keys = torch.full((n_rows, n_cols), PAD_KEY, dtype=torch.int32, device="cuda")
    drawn = torch.randint(0, key_space, (n_rows, live), generator=g,
                          device="cuda", dtype=torch.int32)
    keys[:, :live] = torch.sort(drawn, dim=1).values
    vals = torch.randint(200, 4000, (n_rows, n_cols), generator=g,
                         device="cuda", dtype=torch.int32)
    return keys, vals


def edge_rows():
    """Rows that stress tile edges: all-PAD, one key, runs across many
    tiles and ending on tile edges, and sums above 2**24."""
    from repro_torch.mapreduce.phases import PAD_KEY

    tile = 4096
    cases = {}
    cases["all_pad"] = (torch.full((3, 10_000), PAD_KEY, dtype=torch.int32),
                        torch.ones((3, 10_000), dtype=torch.int32))
    one = torch.full((1, 1_000_003), 7, dtype=torch.int32)
    cases["one_key_above_2^24"] = (one, torch.full_like(one, 40))
    long_run = torch.cat([
        torch.zeros(5, dtype=torch.int32),
        torch.full((20 * tile + 17,), 3, dtype=torch.int32),
        torch.arange(4, 4 + 3 * tile, dtype=torch.int32),
        torch.full((tile,), PAD_KEY, dtype=torch.int32),
    ])[None]
    cases["run_across_tiles"] = (long_run, torch.ones_like(long_run) * 999)
    edges = torch.repeat_interleave(torch.arange(6, dtype=torch.int32),
                                    torch.tensor([tile, tile - 1, 1, 2 * tile, tile + 1, 3]))
    edges = torch.cat([edges, torch.full((tile - 4,), PAD_KEY, dtype=torch.int32)])[None]
    cases["runs_on_tile_edges"] = (edges, torch.arange(edges.numel(), dtype=torch.int32)[None])
    single = torch.tensor([[5]], dtype=torch.int32)
    cases["one_slot"] = (single, torch.tensor([[9]], dtype=torch.int32))
    return {name: (k.cuda(), v.cuda()) for name, (k, v) in cases.items()}


def max_abs_err(got, want) -> int:
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path, compiler_log = _build.build()
    _build.load()
    log("build", f"built {path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in compiler_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("build", line.strip())


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns the kernels-line
    numbers of the main path's shapes."""
    from repro_torch.kernels.local_reduce import local_reduce, local_reduce_ref
    from repro_torch.kernels.segment_reduce import segment_reduce, segment_reduce_ref
    from repro_torch.mapreduce.phases import partition_capacity

    kernels = {"segment_reduce": (segment_reduce, segment_reduce_ref),
               "local_reduce": (local_reduce, local_reduce_ref)}
    errs = {name: 0 for name in kernels}
    for case, (k, v) in edge_rows().items():
        for name, (kern, ref) in kernels.items():
            got, want = kern(k, v), ref(k, v)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name} differs from its plain version on {case}")
            errs[name] = max(errs[name], max_abs_err(got, want))
        log("kernels", f"edge row {case} {tuple(k.shape)}: both kernels bit-exact")

    cap_path = partition_capacity(TOKENS, PATH_R, 4.0)
    shapes = {
        "segment_reduce": [(1, cap_path), (40, partition_capacity(TOKENS, 40, 4.0))],
        "local_reduce": [(PATH_M, math.ceil(TOKENS / PATH_M)), (1, cap_path),
                         (40, math.ceil(TOKENS / 40))],
    }
    # Reduce partitions hold about 1/4 live slots (capacity factor 4) over
    # the 4096-word vocabulary; map-task rows are all live.
    fills = {"segment_reduce": 0.25, "local_reduce": 1.0}
    report = {}
    for name, (kern, ref) in kernels.items():
        for i, (n_rows, n_cols) in enumerate(shapes[name]):
            k, v = sorted_rows(n_rows, n_cols, key_space=4096,
                               fill=fills[name], seed=i)
            got, want = kern(k, v), ref(k, v)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name} differs from its plain version at {(n_rows, n_cols)}")
            errs[name] = max(errs[name], max_abs_err(got, want))
            del got, want
            ms = device_ms(lambda: kern(k, v))
            plain_ms = device_ms(lambda: ref(k, v), iters=3, warmup=1)
            bound_ms = n_rows * n_cols * 16 / HBM_BYTES_PER_S * 1e3
            log("kernels", f"{name} {(n_rows, n_cols)}: bit-exact; kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (16 B/slot at "
                f"3.35 TB/s), library call: none")
            if i == 0:
                report[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "shape": [n_rows, n_cols]}
            del k, v
    for name in kernels:
        report[name]["max_abs_err"] = errs[name]
    return report


def exim_expected(corpus: np.ndarray, M: int) -> dict:
    """Per-transaction byte sums as the engine parses them: each of the M
    splits holds whole records from its own start; a record cut by the
    corpus end is dropped."""
    n = len(corpus)
    S = math.ceil(n / M)
    padded = np.zeros(M * S, dtype=np.int64)
    padded[:n] = corpus
    live = np.arange(M * S) < n
    n_rec = S // 3
    rec = padded.reshape(M, S)[:, : n_rec * 3].reshape(M, n_rec, 3)
    ok = live.reshape(M, S)[:, : n_rec * 3].reshape(M, n_rec, 3).all(axis=2)
    keys, sizes = rec[..., 0][ok], rec[..., 2][ok]
    sums = np.bincount(keys, weights=sizes).astype(np.int64)
    return {int(k): int(sums[k]) for k in np.flatnonzero(np.bincount(keys))}


def live_pairs(ok, ov):
    live = ok != 2**31 - 1
    return ok[live], ov[live]


def phase_engine(apps: dict, expect: dict) -> int:
    """Full-size jobs, "cuda" against "torch"; returns the segment_reduce
    launches the "cuda" jobs must have made."""
    from repro_torch.kernels.local_reduce import local_reduce
    from repro_torch.kernels.segment_reduce import segment_reduce
    from repro_torch.mapreduce import JobConfig, build_job, collect_results

    waves = 0
    combines = 0
    for name, (app, corpus) in apps.items():
        for M, R, W in ENGINE_CONFIGS:
            outs, times = {}, {}
            for backend in ("cuda", "torch"):
                cfg = JobConfig(M, R, W, reduce_backend=backend)
                job = build_job(app, cfg, len(corpus), device="cuda")
                outs[backend] = job(corpus)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                job(corpus)
                torch.cuda.synchronize()
                times[backend] = time.perf_counter() - t0
                if backend == "cuda":
                    waves += 2 * cfg.reduce_waves
            if not all(torch.equal(a, b) for a, b in zip(outs["cuda"], outs["torch"])):
                raise AssertionError(f"{name} {(M, R, W)}: cuda and torch outputs differ")
            ok, ov, dropped = outs["cuda"]
            got, want, dropped = collect_results(*live_pairs(ok, ov)), expect[(name, M)], int(dropped)
            if dropped == 0:
                if got != want:
                    raise AssertionError(f"{name} {(M, R, W)}: results differ from numpy count")
                check = "== numpy count"
            else:
                # Zipf skew overflows a partition at large R; the loss must be
                # counted.  WordCount values are 1 per pair, so pairs conserve.
                if name != "wordcount" or sum(got.values()) + dropped != sum(want.values()) \
                        or any(v > want.get(k, 0) for k, v in got.items()):
                    raise AssertionError(f"{name} {(M, R, W)}: {dropped} dropped pairs unaccounted")
                check = "+ dropped == numpy count"
            log("engine", f"{name} M={M} R={R} W={W} partitions {tuple(ok.shape)}: "
                f"cuda == torch bit for bit, results {check}, dropped {dropped}; "
                f"job {times['cuda'] * 1e3:.1f} ms (cuda), {times['torch'] * 1e3:.1f} ms (torch)")
            del outs, ok, ov
        if name != "wordcount":
            # Exim splits that do not start on a record emit keys above
            # key_space, which the combine cap min(P, key_space) truncates:
            # the reference does the same, so only WordCount is compared.
            continue
        M, R, W = ENGINE_CONFIGS[0]
        plain = build_job(app, JobConfig(M, R, W, reduce_backend="cuda"),
                          len(corpus), device="cuda")(corpus)
        combined = build_job(app, JobConfig(M, R, W, reduce_backend="cuda", combiner=True),
                             len(corpus), device="cuda")(corpus)
        waves += 2 * math.ceil(R / W)
        combines += 1
        a, b = live_pairs(*plain[:2]), live_pairs(*combined[:2])
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"{name}: combiner on differs from combiner off")
        log("engine", f"{name} M={M} R={R} W={W} combiner: live (key, value) pairs "
            f"bit-identical to combiner off ({a[0].numel()} pairs), partitions "
            f"{tuple(plain[0].shape)} -> {tuple(combined[0].shape)}")
        del plain, combined
    if segment_reduce.launches != waves or local_reduce.launches != combines:
        raise AssertionError(
            f"engine launches segment_reduce={segment_reduce.launches} (want {waves}), "
            f"local_reduce={local_reduce.launches} (want {combines})")
    log("engine", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return waves


def phase_loop(apps: dict) -> int:
    """The paper's loop per app; returns the segment_reduce launches made."""
    from repro_torch.core import fit, prediction_error_stats, profile_experiments
    from repro_torch.runner import JobRunner, heldout_configs, training_configs

    train, held = training_configs(), heldout_configs()
    launches = 0
    for name, (app, corpus) in apps.items():
        runner = JobRunner(app, corpus, device="cuda", reduce_backend="cuda")
        t0 = time.perf_counter()
        prof = profile_experiments(runner, train, repeats=REPEATS,
                                   param_names=("mappers", "reducers"))
        held_prof = profile_experiments(runner, held, repeats=REPEATS,
                                        param_names=("mappers", "reducers"))
        for (m, r), t in zip(prof.params, prof.times):
            log("loop", f"{name} train M={int(m)} R={int(r)} mean {t * 1e3:.2f} ms")
        model = fit(prof.params, prof.times, device="cuda")
        stats = prediction_error_stats(model, held, held_prof.times, device="cuda")
        pred = model.predict(held, device="cuda").cpu().numpy()
        for (m, r), t, p in zip(held, held_prof.times, pred):
            log("loop", f"{name} heldout M={int(m)} R={int(r)} mean {t * 1e3:.2f} ms "
                f"predicted {p * 1e3:.2f} ms")
        if not np.isfinite(pred).all():
            raise AssertionError(f"{name}: non-finite predictions")
        log("loop", f"{name}: train MAPE {model.train_mape:.2f}%, R^2 {model.r2:.4f}, "
            f"heldout mean error {stats['mean_pct']:.2f}% (max {stats['max_pct']:.2f}%), "
            f"repeats {REPEATS}, {time.perf_counter() - t0:.1f} s")
        calls = [int(round(r)) for r in np.concatenate([prof.params, held_prof.params])[:, 1]
                 for _ in range(REPEATS)]
        first_runs = {(int(round(m)), int(round(r)))
                      for m, r in np.concatenate([train, held])}
        launches += sum(calls) + sum(r for _, r in first_runs)
    return launches


def phase_breakdown(apps: dict) -> None:
    """Where a full-size job's time goes: each phase fenced and
    wall-clocked, per reduce backend; then one "cuda" WordCount job under
    torch.profiler, with device time by kernel and the device's busy share
    of the job's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.mapreduce import ExecutionPlan, JobConfig

    M, R, W = ENGINE_CONFIGS[0]
    for name, (app, corpus) in apps.items():
        for backend in ("cuda", "torch"):
            plan = ExecutionPlan(app, JobConfig(M, R, W, reduce_backend=backend),
                                 len(corpus), device="cuda")
            fns = plan.phase_fns()
            walls = {}
            for _ in range(2):  # the first pass warms the allocator
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                bufs = fns["map"](corpus)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                pk, pv, _ = fns["shuffle"](*bufs)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                fns["reduce"](pk, pv)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                walls = {"map": t1 - t0, "shuffle": t2 - t1, "reduce": t3 - t2}
                del bufs, pk, pv
            total = sum(walls.values())
            log("breakdown", f"{name} M={M} R={R} W={W} {backend}: " + ", ".join(
                f"{k} {v * 1e3:.2f} ms ({v / total:.0%})" for k, v in walls.items()))
    app, corpus = apps["wordcount"]
    from repro_torch.mapreduce import build_job

    job = build_job(app, JobConfig(M, R, W, reduce_backend="cuda"), len(corpus),
                    device="cuda")
    job(corpus)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        job(corpus)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    busy = sum(by_kernel.values())
    log("breakdown", f"wordcount cuda job under torch.profiler: wall {wall_us / 1e3:.2f} ms, "
        f"device busy {busy / 1e3:.2f} ms ({busy / wall_us:.0%}), "
        f"{len(by_kernel)} distinct device ops")
    for kname, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        log("breakdown", f"  {us / 1e3:8.3f} ms  {kname[:100]}")


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside the repository)
    from repro_torch.kernels.local_reduce import local_reduce
    from repro_torch.kernels.segment_reduce import segment_reduce
    from repro_torch.runner import make_app

    t_start = time.perf_counter()
    print(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    phase_build()
    report = phase_kernels()

    t0 = time.perf_counter()
    apps = {name: make_app(name, TOKENS) for name in ("wordcount", "eximparse")}
    expect = {}
    for M, _, _ in ENGINE_CONFIGS:
        counts = np.bincount(apps["wordcount"][1])
        expect[("wordcount", M)] = {int(k): int(counts[k]) for k in np.flatnonzero(counts)}
        expect[("eximparse", M)] = exim_expected(apps["eximparse"][1], M)
    apps = {name: (app, torch.as_tensor(corpus, device="cuda"))
            for name, (app, corpus) in apps.items()}
    log("engine", f"corpora: 2^26 tokens each, made in {time.perf_counter() - t0:.1f} s")

    # The main path: phases 3 and 4, counted from zero.
    segment_reduce.launches = 0
    local_reduce.launches = 0
    want = phase_engine(apps, expect)
    want += phase_loop(apps)
    launches = {"segment_reduce": segment_reduce.launches,
                "local_reduce": local_reduce.launches}
    if launches["segment_reduce"] != want or launches["local_reduce"] < 1:
        raise AssertionError(f"main path launches {launches}, want segment_reduce={want}")
    log("launches", f"main path: segment_reduce {launches['segment_reduce']} "
        f"(one per reduce wave), local_reduce {launches['local_reduce']} (one per combiner job)")
    phase_breakdown(apps)

    sources = {"segment_reduce": ("src/repro_torch/csrc/segment_reduce.cu",
                                  "src/repro/kernels/segment_reduce/kernel.py:28"),
               "local_reduce": ("src/repro_torch/csrc/local_reduce.cu",
                                "src/repro/kernels/local_reduce/kernel.py:36")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": report[name]["max_abs_err"],
         "ms": report[name]["ms"], "plain_ms": report[name]["plain_ms"],
         "bound_ms": report[name]["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "shape": report[name]["shape"]}
        for name, (src, replaces) in sources.items()]}
    print(json.dumps(line))
    print(f"card: {card_line()}")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
