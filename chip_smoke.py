#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one or more printed lines each, in run order:

1. build: compile the hand-written kernels from ``src/repro_torch/csrc``,
   print ptxas's registers and spills, and require HGMMA (wgmma) and
   UTMALDG (TMA loads) in the SASS of every bfloat16 attention kernel (the
   head_dim 64, 128 and 256 instances), TF32 tensor-core MMAs and LDGSTS
   (cp.async) in both WKV6 kernels, and no spill (LDL/STL) in any of them;
2. kernels: hold each MapReduce kernel against its plain PyTorch version on
   the card, bit for bit, at the main path's shapes and on edge rows
   (all-PAD, one key, a run across many tiles, sums above 2**24), with its
   time, the plain version's time and its memory bound;
3. attention: the two attention kernels against their plain versions on
   the card at the qwen3-0.6b serving shapes and gemma-7b's head_dim 256
   shapes (decode over a ragged kv_len split into 64-key tiles, the
   long-prompt prefill, flash causal and non-causal with Sk > Sq), bfloat16
   and float32, and on edge cases (garbage past kv_len, kv_len past the
   cache, a ragged sequence, non-causal with Sk > Sq), elementwise and row
   by row relative to each row's scale, with proof at each bfloat16 shape
   that the check rejects an all-zero output and a dropped key split or
   lost key tile; with their time, the plain version's,
   ``scaled_dot_product_attention``'s and the bound;
4. engine: both applications at 2**26 tokens through ``build_job`` with the
   ``"cuda"`` and ``"torch"`` reduce backends at a few (M, R, W): outputs
   bit-identical, results equal to a numpy count of the corpus, and
   WordCount's combiner run equal to the run without it;
5. loop: the paper's profile -> fit -> predict loop per application, 20
   training and 8 held-out (M, R) settings, reduce backend ``"cuda"``;
   then the launch counts of phases 4-5 (the MapReduce main path), which
   must be exactly one ``segment_reduce`` per reduce wave and one
   ``local_reduce`` per combiner job;
6. breakdown: where one full-size job's time goes, phase by phase from the
   traced mode's JobTrace and (under ``torch.profiler``) kernel by kernel,
   with the device's busy share;
7. traced: both applications at 2**26 tokens at the engine's (M, R, W) and
   WordCount with its combiner, through ``build_job(...,
   recorder=PhaseRecorder())``: outputs bit-equal to the fused mode's,
   ``check_conservation()`` empty, ``map.pairs_emitted`` equal to the
   numpy count of valid pairs, ``reduce.segments_out`` equal to the
   distinct keys of the numpy count (when nothing dropped),
   ``combine.net_bytes`` 0; per-phase walls and counters printed;
8. pipelined: the same jobs in the pipelined mode at depths 1, 2 and 3:
   outputs bit-equal to fused, exactly ceil(R / min(W D, R))
   ``segment_reduce`` launches and one ``local_reduce`` (with the combiner)
   a job, the traced form at depth 2 with its ``pipeline`` phase
   conserving; each depth's job wall beside fused's, as information;
9. a2a: both applications at 2**26 tokens at the engine's (M, R, W) with
   the all-to-all shuffle (pack, block transpose, unpack on one card):
   the fused job equal to the numpy count when nothing dropped, traced
   and pipelined (D = 2) bit-equal to it, the traced form conserving,
   WordCount's combiner run equal to the run without it; then the
   sharded mode on an NCCL process group of one rank at (20, 5, 1),
   bit-equal to the emulated mode at W = 1, with its per-worker overflow
   stats; exactly ceil(R / W) ``segment_reduce`` launches an emulated
   job, ceil(R / min(W D, R)) a pipelined one, R a sharded one at W = 1
   and one ``local_reduce`` a combiner job; job and traced shuffle walls
   beside the lexsort ones, as information;
10. elastic: resumable jobs (WordCount and Exim at (20, 5), and WordCount
   with its combiner, backend ``"cuda"``) under the grant schedule
   1 -> 4 -> 2, lexsort bit-equal to fused and all_to_all's collected
   results equal to fused's; lexsort snapshots through
   ``CheckpointManager`` mid-map, right after the shuffle and
   mid-reduce, each restored into a fresh job and resumed bit-equal to
   fused, with its bytes and save and restore walls; one
   ``segment_reduce`` a reduce step and one ``local_reduce`` a combine
   step;
11. estimator: ``stage_cost_estimates`` for both applications at (20, 5,
   1), backend ``"cuda"``, and WordCount with its combiner: every phase
   available (combine included), the shuffle's ``net_bytes`` equal to its
   pair slots times 8, no kernel launched; each phase's bytes over its
   traced wall from phase 7, beside the card's HBM rate, as information;
12. cluster: the predictive scheduler on the live engine: a traced
   ``EngineOracle`` on the card, a 12-job trace of 2**22-2**26 tokens on
   16 workers under predict-combine (backends ``torch`` and ``cuda``,
   combiner off and on; it bootstraps the shared model database),
   predict-sjf, predict-deadline and fifo-static on ``cuda``; then
   predict-elastic on an ``ElasticCluster`` (7 jobs of 2**22-2**24
   tokens), which must regrant on measured snapshot walls; then the
   cluster CLI once in-process (``--oracle engine-traced``, 8 jobs, its
   span trace).  Every job completes or is rejected, fifo-static
   completes all, every trace conserves with its configuration's phases,
   and the ``segment_reduce`` / ``local_reduce`` launches equal what the
   oracle's ``cuda`` runs must make (one a reduce wave or step, one a
   combiner job, warmups included); per policy the makespan, mean
   turnaround, SLO attainment, the share of ``cuda`` plans and the online
   prediction error beside the paper's 5 %, as information; phases 7-12
   each count their launches from zero;
13. serve: the LM serving path (the second main path) at the full width of
   qwen3-0.6b: latency profile, fit and SLO batch pick, 32 requests, the
   prediction at unprofiled batches 3 and 6 against a measurement, a batch
   of 2048-token prompts, decode-vs-forward logits, the 28-layer logits of
   the kernel path against the same path with the kernels' plain versions
   (elementwise) and against the plain ``use_flash=False`` path, 2048-token
   scoring logits, loss and time, attention launch counts equal to 28 per
   decode_step and forward call the phase drives, and the device time by
   kernel of the long prompts' prefill and of one decode step;
14. gemma: the same serving path at the full width of gemma-7b (28 layers,
   16 heads of 256, GeGLU, vocabulary 256000, 17 GB of bf16 weights): 8
   requests, 8 prompts of 2048 tokens with 32 new tokens into a 4096-slot
   cache, each layer's attention call held against its plain version, the
   28-layer logits within their measured floor, attention launches 28 per
   call;
15. wkv6: the WKV6 kernel pair against its plain version (the chunked form)
   on the card, float32 at the reference test's shapes (ragged T, w = 1e-6),
   bf16 r, k, v with a non-zero initial state at the rwkv6-3b long-prompt
   batch, one 2048-token and one 32768-token sequence, elementwise and row
   by row, and the long-prompt batch with w at its 1e-8 clamp against the
   same chunked form computed in float64, with proof
   that the check rejects an ignored initial state, a dropped bonus
   diagonal and a lost chunk state update; its time, the plain version's
   and the bound with both its terms;
16. rwkv: the rwkv6-3b serving and scoring path at full width (32 layers):
   the same serving steps as phase 13, decode-vs-forward logits across
   chunks, each layer's wkv6 call held against its plain version, the
   32-layer logits against the path with the plain version within a
   measured floor, 2048-token scoring, wkv6 launches equal to 32 per
   decode_step and forward call of more than one token and none at one
   token, and one decode step's device time by kernel.

Then a ``kernels`` JSON line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; so does a machine without a CUDA device, or a copy of this file
outside the repository.  Nothing here imports JAX or the reference package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOKENS = 1 << 26
#: the paper takes the mean of 5 runs per setting
REPEATS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak, same sheet
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
        if any(word in line for word in ("registers", "spill", "entry function", "warning",
                                         "Performance Loss")) \
                or line.startswith("=="):
            log("build", line.strip())
    hopper_sass(path, Path(_build._nvcc()).parent / "cuobjdump")


#: kernels whose SASS must hold Hopper's instructions: name -> (number of
#: instantiations, {what: substrings one SASS line must all hold}, whether
#: it must hold no local-memory instruction (LDL/STL), so no spill).  The
#: bfloat16 attention kernels (head_dim 64, 128 and 256 instances) run
#: wgmma on TMA tiles; each WKV6 kernel runs TF32 tensor-core MMAs on tiles
#: loaded by cp.async (LDGSTS); none spills.
HOPPER_KERNELS = {
    "flash_attention_bf16": (3, {"HGMMA": ("HGMMA",), "UTMALDG": ("UTMALDG",)}, True),
    "decode_attention_bf16": (3, {"HGMMA": ("HGMMA",), "UTMALDG": ("UTMALDG",)}, True),
    "wkv6_states": (2, {"TF32 MMA": ("MMA", "TF32"), "LDGSTS": ("LDGSTS",)}, True),
    "wkv6_outputs": (3, {"TF32 MMA": ("MMA", "TF32"), "LDGSTS": ("LDGSTS",)}, True),
}


def hopper_sass(path: Path, cuobjdump: Path) -> None:
    """Each instantiation of HOPPER_KERNELS must hold its instructions in
    its SASS, and those marked so no local-memory access: a spill would
    show as LDL/STL."""
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=600).stdout
    found: dict[str, dict[str, list]] = {}
    name = kernel = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            kernel = next((k for k in HOPPER_KERNELS if k in name), None)
            if kernel:
                found[name] = {what: [] for what in HOPPER_KERNELS[kernel][1]} | {"local": []}
        elif kernel:
            code = line.split("*/", 1)[-1].split("/*")[0].strip()
            for what, parts in HOPPER_KERNELS[kernel][1].items():
                if all(part in code for part in parts):
                    found[name][what].append(code)
            words = code.split()
            op = words[1] if len(words) > 1 and words[0].startswith("@") else (words or [""])[0]
            if HOPPER_KERNELS[kernel][2] and op.split(".")[0] in ("LDL", "STL"):
                found[name]["local"].append(code)
    counts = {k: sum(k in n for n in found) for k in HOPPER_KERNELS}
    missing = {n: [what for what, lines in ops.items() if what != "local" and not lines]
               for n, ops in found.items()}
    if any(counts[k] != want for k, (want, _, _) in HOPPER_KERNELS.items()) or any(
            missing.values()) or any(ops["local"] for ops in found.values()):
        raise AssertionError(f"kernels without their Hopper instructions, or spilling, in SASS: "
                             f"{ {n: {what: len(v) for what, v in ops.items()} for n, ops in found.items()} }")
    for n, ops in sorted(found.items()):
        log("build", f"SASS {n}: " + "; ".join(
            f"{len(lines)} {what}, e.g. '{lines[0]}'" for what, lines in ops.items()
            if what != "local") + "; no LDL/STL" * any(
                k in n and no_local for k, (_, _, no_local) in HOPPER_KERNELS.items()))


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


def exim_expected(corpus: np.ndarray, M: int) -> tuple[dict, int]:
    """Per-transaction byte sums as the engine parses them, and the number
    of records (the pairs the map emits): each of the M splits holds whole
    records from its own start; a record cut by the corpus end is dropped."""
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
    return {int(k): int(sums[k]) for k in np.flatnonzero(np.bincount(keys))}, len(keys)


def live_pairs(ok, ov):
    live = ok != 2**31 - 1
    return ok[live], ov[live]


def timed_job(job, corpus):
    """(output, wall s) of a warm call of ``job``, fenced."""
    job(corpus)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = job(corpus)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_results(tag: str, got: dict, want: dict, dropped: int, name: str) -> str:
    """Results against numpy's count: equal when nothing dropped, else (for
    WordCount, whose values are 1 a pair) the dropped pairs account for
    the difference."""
    if dropped == 0:
        if got != want:
            raise AssertionError(f"{tag}: results differ from numpy count")
        return "== numpy count"
    if name != "wordcount" or sum(got.values()) + dropped != sum(want.values()) \
            or any(v > want.get(k, 0) for k, v in got.items()):
        raise AssertionError(f"{tag}: {dropped} dropped pairs unaccounted")
    return "+ dropped == numpy count"


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
            # Zipf skew overflows a partition at large R; the loss must be
            # counted.
            dropped = int(dropped)
            check = check_results(f"{name} {(M, R, W)}", collect_results(*live_pairs(ok, ov)),
                                  expect[(name, M)], dropped, name)
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
    wall-clocked by the traced mode, per reduce backend; then one "cuda"
    WordCount job under torch.profiler, with device time by kernel and the
    device's busy share of the job's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.mapreduce import JobConfig, build_job
    from repro_torch.telemetry import PhaseRecorder

    M, R, W = ENGINE_CONFIGS[0]
    for name, (app, corpus) in apps.items():
        for backend in ("cuda", "torch"):
            recorder = PhaseRecorder()
            job = build_job(app, JobConfig(M, R, W, reduce_backend=backend), len(corpus),
                            recorder=recorder, device="cuda")
            for _ in range(2):  # the first pass warms the allocator
                job(corpus)
            walls = recorder.last.phase_times()
            total = sum(walls.values())
            log("breakdown", f"{name} M={M} R={R} W={W} {backend}: " + ", ".join(
                f"{k} {v * 1e3:.2f} ms ({v / total:.0%})" for k, v in walls.items()))
    app, corpus = apps["wordcount"]
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


def mapreduce_jobs(apps: dict):
    """(name, app, corpus, JobConfig) of the traced and pipelined phases:
    both applications at ENGINE_CONFIGS, reduce backend "cuda", and
    WordCount's first config with its combiner."""
    from repro_torch.mapreduce import JobConfig

    for name, (app, corpus) in apps.items():
        for M, R, W in ENGINE_CONFIGS:
            yield name, app, corpus, JobConfig(M, R, W, reduce_backend="cuda")
    app, corpus = apps["wordcount"]
    yield "wordcount", app, corpus, JobConfig(*ENGINE_CONFIGS[0], reduce_backend="cuda",
                                              combiner=True)


def phase_traced(apps: dict, expect: dict, pairs: dict, traces: dict) -> dict:
    """The traced mode at full size: every job of ``mapreduce_jobs`` through
    ``build_job(..., recorder=PhaseRecorder())``, outputs bit-equal to the
    fused mode's, counters held against numpy counts of the corpus, the
    conservation laws checked.  Each job's warm JobTrace goes into
    ``traces`` under (name, M, R, W, combiner).  Returns the launches its
    jobs must have made: one segment_reduce a reduce wave, one local_reduce
    a combiner job."""
    from repro_torch.mapreduce import build_job
    from repro_torch.telemetry import PhaseRecorder

    seg = loc = 0
    for name, app, corpus, cfg in mapreduce_jobs(apps):
        M, R, W = cfg.num_mappers, cfg.num_reducers, cfg.num_workers
        fused = build_job(app, cfg, len(corpus), device="cuda")(corpus)
        recorder = PhaseRecorder()
        job = build_job(app, cfg, len(corpus), recorder=recorder, device="cuda")
        got = job(corpus)
        seg += 2 * cfg.reduce_waves  # the fused job and the traced one
        loc += 2 * int(cfg.combiner)
        if not all(torch.equal(a, b) for a, b in zip(got, fused)):
            raise AssertionError(f"traced {name} {(M, R, W)}: outputs differ from fused")
        trace = recorder.last
        bad = trace.check_conservation()
        dropped = int(got[2])
        distinct = len(expect[(name, M)])
        emitted = trace.counter("map", "pairs_emitted")
        segments = trace.counter("reduce", "segments_out")
        if bad or emitted != pairs[(name, M)]:
            raise AssertionError(f"traced {name} {(M, R, W)}: {bad}, pairs_emitted {emitted} "
                                 f"against numpy's {pairs[(name, M)]}")
        # A key's pairs all go to one partition and sum in one run, so the
        # segments are the distinct keys unless a partition overflowed.
        if (dropped == 0 and segments != distinct) or segments > distinct:
            raise AssertionError(f"traced {name} {(M, R, W)}: segments_out {segments}, "
                                 f"{distinct} distinct keys in numpy's count, {dropped} dropped")
        if cfg.combiner and trace.counter("combine", "net_bytes") != 0:
            raise AssertionError("combine phase moved fabric bytes")
        job(corpus)  # a second, warm run for the walls
        trace = traces[(name, M, R, W, cfg.combiner)] = recorder.last
        seg += cfg.reduce_waves
        loc += int(cfg.combiner)
        log("traced", f"{name} M={M} R={R} W={W}{' combiner' if cfg.combiner else ''}: "
            f"== fused bit for bit, conserves, pairs_emitted {int(emitted)} == numpy, "
            f"segments_out {int(segments)} ({distinct} distinct keys, {dropped} dropped); "
            f"total {trace.total_s * 1e3:.2f} ms: " + ", ".join(
                f"{p.phase} {p.wall_s * 1e3:.2f} ms" for p in trace.phases))
        log("traced", "  counters: " + "; ".join(
            f"{p.phase} " + " ".join(f"{k}={v:g}" for k, v in sorted(p.counters.items())
                                     if k not in ("cpu_workers",))
            for p in trace.phases))
    return {"segment_reduce": seg, "local_reduce": loc}


def phase_pipelined(apps: dict) -> dict:
    """The pipelined mode at full size: every job of ``mapreduce_jobs`` at
    depths 1, 2 and 3, outputs bit-equal to fused, one segment_reduce a
    wave group (ceil(R / min(W D, R)) a job) and one local_reduce a
    combiner job; the traced form at depth 2 records the pipeline phase
    and conserves.  Job walls beside fused's are information only.
    Returns the launches the phase's jobs must have made."""
    from repro_torch.kernels.local_reduce import local_reduce
    from repro_torch.kernels.segment_reduce import segment_reduce
    from repro_torch.mapreduce import ExecutionPlan
    from repro_torch.telemetry import PhaseRecorder

    want = {"segment_reduce": 0, "local_reduce": 0}
    for name, app, corpus, cfg in mapreduce_jobs(apps):
        M, R, W = cfg.num_mappers, cfg.num_reducers, cfg.num_workers
        plan = ExecutionPlan(app, cfg, len(corpus), device="cuda")
        fused, t_fused = timed_job(plan.fused(), corpus)
        want["segment_reduce"] += 2 * cfg.reduce_waves
        want["local_reduce"] += 2 * int(cfg.combiner)
        walls = []
        for depth in (1, 2, 3):
            job = plan.pipelined(depth=depth)
            job(corpus)
            torch.cuda.synchronize()
            before = segment_reduce.launches, local_reduce.launches
            got, wall = timed_job(job, corpus)
            groups = math.ceil(R / min(W * depth, R))
            made = (segment_reduce.launches - before[0], local_reduce.launches - before[1])
            want["segment_reduce"] += 3 * groups
            want["local_reduce"] += 3 * int(cfg.combiner)
            if made != (2 * groups, 2 * int(cfg.combiner)):
                raise AssertionError(f"pipelined {name} {(M, R, W)} depth {depth}: launches "
                                     f"{made} for two jobs, want {groups} and "
                                     f"{int(cfg.combiner)} a job")
            if not all(torch.equal(a, b) for a, b in zip(got, fused)):
                raise AssertionError(f"pipelined {name} {(M, R, W)} depth {depth}: outputs "
                                     "differ from fused")
            walls.append(f"D={depth} {wall * 1e3:.2f} ms ({groups} reduce launches)")
        recorder = PhaseRecorder()
        got = plan.traced(recorder, depth=2)(corpus)
        want["segment_reduce"] += math.ceil(R / min(2 * W, R))
        want["local_reduce"] += int(cfg.combiner)
        trace = recorder.last
        if not all(torch.equal(a, b) for a, b in zip(got, fused)) or \
                trace.phase_names()[-1] != "pipeline" or trace.check_conservation():
            raise AssertionError(f"traced D=2 {name} {(M, R, W)}: {trace.phase_names()}, "
                                 f"{trace.check_conservation()}")
        log("pipelined", f"{name} M={M} R={R} W={W}{' combiner' if cfg.combiner else ''}: "
            f"depths 1-3 == fused bit for bit; job wall fused {t_fused * 1e3:.2f} ms, "
            + ", ".join(walls) + f"; traced D=2 conserves, pipeline phase "
            f"{trace.phase('pipeline').wall_s * 1e3:.3f} ms of {trace.total_s * 1e3:.2f} ms")
    return want


@contextlib.contextmanager
def nccl_world1():
    """An NCCL process group of one rank on card 0 (NCCL puts no two ranks
    on one card), initialised through a file; destroyed on exit."""
    import datetime
    import tempfile

    import torch.distributed as dist

    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


def phase_a2a(apps: dict, expect: dict) -> dict:
    """The all-to-all shuffle at full size.  Both applications at
    ENGINE_CONFIGS with shuffle "all_to_all", backend "cuda": the emulated
    fused job == numpy's count when nothing dropped, traced and pipelined
    (D = 2) bit-equal to it and conserving, WordCount's combiner run equal
    to the run without it; then the sharded mode on an NCCL group of one
    rank at (20, 5, 1), bit-equal to the emulated mode at W = 1, with its
    per-worker overflow stats.  Walls beside the lexsort fused job's, and
    the shuffle's from the traced phases, are information only.  Returns
    the launches its jobs must have made."""
    from repro_torch.mapreduce import ExecutionPlan, JobConfig, collect_results
    from repro_torch.telemetry import PhaseRecorder

    want = {"segment_reduce": 0, "local_reduce": 0}

    def count(cfg, jobs, groups=None):
        want["segment_reduce"] += jobs * (cfg.reduce_waves if groups is None else groups)
        want["local_reduce"] += jobs * int(cfg.combiner)

    with nccl_world1() as group:
        for name, (app, corpus) in apps.items():
            for M, R, W in ENGINE_CONFIGS:
                walls, shuffles, outs = {}, {}, {}
                for sb in ("lexsort", "all_to_all"):
                    cfg = JobConfig(M, R, W, reduce_backend="cuda", shuffle_backend=sb)
                    plan = ExecutionPlan(app, cfg, len(corpus), device="cuda")
                    outs[sb], walls[sb] = timed_job(plan.fused(), corpus)
                    recorder = PhaseRecorder()
                    traced = plan.traced(recorder)(corpus)
                    count(cfg, 3)
                    shuffles[sb] = recorder.last.phase("shuffle").wall_s
                    if not all(torch.equal(a, b) for a, b in zip(traced, outs[sb])) \
                            or recorder.last.check_conservation():
                        raise AssertionError(f"a2a {sb} {name} {(M, R, W)}: traced differs "
                                             f"or {recorder.last.check_conservation()}")
                ok, ov, dropped = outs["all_to_all"]
                tag = f"a2a {name} {(M, R, W)}"
                check = check_results(tag, collect_results(*live_pairs(ok, ov)),
                                      expect[(name, M)], int(dropped), name)
                piped = plan.pipelined(depth=2)(corpus)
                count(cfg, 1, math.ceil(R / min(2 * W, R)))
                if not all(torch.equal(a, b) for a, b in zip(piped, outs["all_to_all"])):
                    raise AssertionError(f"{tag}: pipelined D=2 differs from fused")
                line = (f"{name} M={M} R={R} W={W} partitions {tuple(ok.shape)}: fused "
                        f"{check}, dropped {int(dropped)}, traced and pipelined D=2 bit-equal, "
                        f"traced conserves; job wall {walls['all_to_all'] * 1e3:.2f} ms "
                        f"(lexsort {walls['lexsort'] * 1e3:.2f} ms), traced shuffle "
                        f"{shuffles['all_to_all'] * 1e3:.2f} ms (lexsort "
                        f"{shuffles['lexsort'] * 1e3:.2f} ms)")
                if name == "wordcount":
                    ccfg = dataclasses.replace(cfg, combiner=True)
                    cplan = ExecutionPlan(app, ccfg, len(corpus), device="cuda")
                    combined, cwall = timed_job(cplan.fused(), corpus)
                    count(ccfg, 2)
                    got = collect_results(*live_pairs(*combined[:2]))
                    ccheck = check_results(tag + " combiner", got, expect[(name, M)],
                                           int(combined[2]), name)
                    if int(dropped) == 0 and got != collect_results(*live_pairs(ok, ov)):
                        raise AssertionError(f"{tag}: combiner on differs from combiner off")
                    line += (f"; combiner {ccheck}" + (", == off" if int(dropped) == 0 else "")
                             + f", dropped {int(combined[2])}, job wall {cwall * 1e3:.2f} ms")
                log("a2a", line)
                if (M, R, W) == ENGINE_CONFIGS[0]:
                    for combiner in (False, True) if name == "wordcount" else (False,):
                        scfg = dataclasses.replace(cfg, combiner=combiner)
                        splan = ExecutionPlan(app, scfg, len(corpus), device="cuda")
                        emulated = outs["all_to_all"] if not combiner else combined
                        (sok, sov, sdropped, stats), swall = timed_job(
                            splan.sharded(group, counters=True), corpus)
                        count(scfg, 2, R)  # one backend call a reduce slot: R at W = 1
                        if not all(torch.equal(x, y) for x, y in
                                   zip((sok, sov, sdropped), emulated)) or \
                                stats["dropped_send"] + stats["dropped_recv"] != int(sdropped):
                            raise AssertionError(f"sharded {name} combiner={combiner}: "
                                                 f"differs from emulated, stats {stats}")
                        log("a2a", f"sharded {name} M={M} R={R} W=1"
                            f"{' combiner' if combiner else ''} on NCCL world size 1: == "
                            f"emulated bit for bit, stats send {stats['dropped_send']} recv "
                            f"{stats['dropped_recv']} per worker "
                            f"{stats['dropped_per_worker'].tolist()}; job wall "
                            f"{swall * 1e3:.2f} ms")
                        del sok, sov
                del outs, ok, ov, piped
    log("a2a", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return want


def phase_elastic(apps: dict) -> dict:
    """Resumable jobs at full size: WordCount and Exim at (M, R) = (20, 5),
    backend "cuda", and WordCount with its combiner.  Under the grant
    schedule 1 -> 4 -> 2 (regrant after the first map wave and after the
    shuffle): lexsort bit-equal to fused, all_to_all's collected results
    equal to fused's.  Then lexsort snapshots through CheckpointManager at
    three boundaries (mid-map, right after the shuffle, mid-reduce), each
    restored into a fresh ResumableJob and resumed: bit-equal to fused.
    Snapshot bytes, save and restore walls are printed.  Returns the
    launches its jobs must have made: one segment_reduce a reduce step,
    one local_reduce a combine step."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.elastic import ResumableJob, load_snapshot, run_resumable, save_snapshot
    from repro_torch.mapreduce import ExecutionPlan, JobConfig, collect_results

    want = {"segment_reduce": 0, "local_reduce": 0}
    M, R = ENGINE_CONFIGS[0][:2]

    def run(job, corpus, state=None, preempt_after=None):
        """run_resumable, counting the reduce and combine steps it ran."""
        b = (state or job.initial_state()).cursor
        out = run_resumable(job, corpus, state=state, preempt_after=preempt_after)
        a = out.cursor
        combines = int(a.combined and not b.combined)
        steps = a.waves_executed - b.waves_executed
        map_steps = math.ceil((a.map_tasks_done - b.map_tasks_done) / b.workers)
        want["segment_reduce"] += steps - map_steps - combines - int(a.shuffled > b.shuffled)
        want["local_reduce"] += combines
        return out

    jobs = [("wordcount", False), ("eximparse", False), ("wordcount", True)]
    for name, combiner in jobs:
        app, corpus = apps[name]
        for sb in ("lexsort", "all_to_all"):
            cfg = JobConfig(M, R, 1, reduce_backend="cuda", shuffle_backend=sb,
                            combiner=combiner)
            plan = ExecutionPlan(app, cfg, len(corpus), device="cuda")
            fused = plan.fused()(corpus)
            want["segment_reduce"] += cfg.reduce_waves
            want["local_reduce"] += int(combiner)
            job = plan.resumable()
            t0 = time.perf_counter()
            state = run(job, corpus, preempt_after=1)                # map wave 1 at W = 1
            state = run(job, corpus, state=job.regrant(state, 4),     # the map at W = 4,
                        preempt_after=math.ceil((M - 1) / 4) + int(combiner) + 1)  # the shuffle
            state = run(job, corpus, state=job.regrant(state, 2))    # the reduce at W = 2
            wall = time.perf_counter() - t0
            got = job.result(state)
            tag = f"elastic {name}{' combiner' if combiner else ''} {sb}"
            if sb == "lexsort":
                if not all(torch.equal(a, b) for a, b in zip(got, fused)):
                    raise AssertionError(f"{tag}: grants 1 -> 4 -> 2 differ from fused")
                check = "bit-equal to fused"
            else:
                if collect_results(*live_pairs(*got[:2])) != \
                        collect_results(*live_pairs(*fused[:2])) or int(got[2]) != int(fused[2]):
                    raise AssertionError(f"{tag}: grants 1 -> 4 -> 2 results differ from fused")
                check = f"results == fused's, partitions {tuple(fused[0].shape)} -> " \
                        f"{tuple(got[0].shape)}"
            log("elastic", f"{tag}: grants 1 -> 4 -> 2, {state.cursor.waves_executed} steps "
                f"in {wall * 1e3:.1f} ms, {check}")
            del got, state
            if sb != "lexsort":
                continue
            shuffled_at = M + int(combiner) + 1
            for where, k in (("mid-map", M // 2), ("after the shuffle", shuffled_at),
                             ("mid-reduce", shuffled_at + 2)):
                with tempfile.TemporaryDirectory() as tmp:
                    state = run(job, corpus, preempt_after=k)
                    mgr = CheckpointManager(tmp, keep=1)
                    step, save_s = save_snapshot(mgr, state)
                    nbytes = sum(f.stat().st_size for f in Path(tmp).glob("step_*/arr_*.npy"))
                    del state
                    restored, _, restore_s = load_snapshot(mgr, step, device="cuda")
                    fresh = ResumableJob(app, cfg, len(corpus), device="cuda")
                    done = run(fresh, corpus, state=restored)
                    if not all(torch.equal(a, b) for a, b in zip(fresh.result(done), fused)):
                        raise AssertionError(f"{tag}: resumed from {where} differs from fused")
                    log("elastic", f"{tag} snapshot {where} (step {step}, "
                        f"{', '.join(sorted(restored.arrays))}): {nbytes} bytes, save "
                        f"{save_s * 1e3:.1f} ms, restore {restore_s * 1e3:.1f} ms; "
                        f"resumed == fused bit for bit")
                    del restored, done
        del fused
    return want


def phase_estimator(apps: dict, traces: dict) -> dict:
    """The static cost estimator at full size: both applications at
    ENGINE_CONFIGS[0] with backend "cuda", and WordCount with its combiner.
    Every phase has a shape-only estimate (combine included), the shuffle's
    net_bytes is the pair slots times PAIR_BYTES, and nothing launches.
    Each phase's bytes over the traced phase wall of the traced path's
    warm JobTrace of the same job is printed beside the card's HBM rate,
    as information.  Returns the launches it must have made: none."""
    from repro_torch.mapreduce import ExecutionPlan, JobConfig
    from repro_torch.mapreduce.phases import PAIR_BYTES
    from repro_torch.telemetry import stage_cost_estimates

    M, R, W = ENGINE_CONFIGS[0]
    for name, combiner in (("wordcount", False), ("eximparse", False), ("wordcount", True)):
        app, corpus = apps[name]
        cfg = JobConfig(M, R, W, reduce_backend="cuda", combiner=combiner)
        t0 = time.perf_counter()
        est = stage_cost_estimates(app, cfg, len(corpus))
        wall = time.perf_counter() - t0
        phases = ["map"] + ["combine"] * combiner + ["shuffle", "reduce"]
        n_pairs = ExecutionPlan(app, cfg, len(corpus), device="meta").meta()["n_pairs"]
        if list(est) != phases or not all(e["available"] for e in est.values()) or \
                est["shuffle"]["net_bytes"] != n_pairs * PAIR_BYTES:
            raise AssertionError(f"estimator {name} combiner={combiner}: {est}")
        trace = traces[(name, M, R, W, combiner)]
        log("estimator", f"{name} M={M} R={R} W={W}{' combiner' if combiner else ''} "
            f"({wall:.2f} s on the host): all phases available, shuffle net_bytes "
            f"{int(est['shuffle']['net_bytes'])} == {n_pairs} pairs x {PAIR_BYTES}; " + "; ".join(
                f"{ph} {e['bytes'] / 1e9:.3f} GB, {e['flops']:.4g} flops, over the traced "
                f"{trace.phase(ph).wall_s * 1e3:.2f} ms = "
                f"{e['bytes'] / trace.phase(ph).wall_s / 1e9:.0f} GB/s"
                for ph, e in est.items())
            + f" (HBM {HBM_BYTES_PER_S / 1e9:.0f} GB/s)")
    return {"segment_reduce": 0, "local_reduce": 0}


#: the [cluster] phase: a trace of CLUSTER_JOBS jobs on CLUSTER_WORKERS
#: workers, sizes log-uniform over CLUSTER_SIZES tokens; the predictive
#: policies bootstrap at BOOTSTRAP_SIZES; the elastic arm runs
#: ELASTIC_JOBS jobs over ELASTIC_SIZES on ELASTIC_WORKERS workers
CLUSTER_JOBS, CLUSTER_WORKERS = 12, 16
CLUSTER_SIZES = (1 << 22, 1 << 26)
BOOTSTRAP_SIZES = (1 << 22, 1 << 24, 1 << 26)
ELASTIC_JOBS, ELASTIC_WORKERS = 7, 8
ELASTIC_SIZES = (1 << 22, 1 << 24)
#: what the elastic arm's regrant cost model believes a snapshot and a
#: restore cost before its first measurement: small beside the jobs'
#: few milliseconds, so the first rescue passes its gate; each regrant is
#: charged the oracle's measured walls, which then replace the prior
ELASTIC_PRIOR_S = 1e-5


def tally_oracle(oracle, want: dict, walls: dict):
    """Wrap the engine oracle's entry points to tally the kernel launches
    its ``cuda`` runs must make: one segment_reduce a reduce wave (or
    reduce step) and one local_reduce a combiner job, for the warmup
    runs too (a new plan, a new grant of a resumable job, a new snapshot
    bucket).  Host walls of bootstrap-profiling calls go to ``walls``."""
    from repro_torch.cluster.oracle import PROFILE_JOB_ID

    time_, segments_, overhead_ = (oracle.time, oracle.remaining_segments,
                                   oracle.regrant_overhead)

    def count(backend, R, W, combiner, runs):
        if backend == "cuda":
            want["segment_reduce"] += runs * math.ceil(R / W)
            want["local_reduce"] += runs * int(combiner)

    def timed(app, backend, size, M, R, W, job_id=0, depth=1, combiner=False):
        assert depth == 1
        n, t0 = len(oracle._jobs), time.perf_counter()
        t = time_(app, backend, size, M, R, W, job_id=job_id, combiner=combiner)
        if job_id >= PROFILE_JOB_ID:
            walls["bootstrap"] += time.perf_counter() - t0
        count(backend, R, W, combiner, 1 + oracle.warmup * (len(oracle._jobs) - n))
        return t

    def segments(app, backend, size, M, R, W, **kw):
        n = len(oracle._warmed)
        out = segments_(app, backend, size, M, R, W, **kw)
        count(backend, R, W, kw.get("combiner", False), 1 + len(oracle._warmed) - n)
        return out

    def overhead(app, backend, size, M, R, **kw):
        n = len(oracle._overheads)
        out = overhead_(app, backend, size, M, R, **kw)
        walls["snapshots"].append(out)
        if len(oracle._overheads) > n and kw.get("shuffled") and backend == "cuda":
            want["local_reduce"] += int(kw.get("combiner", False))
        return out

    oracle.time, oracle.remaining_segments, oracle.regrant_overhead = timed, segments, overhead


def check_records(tag: str, result, n_jobs: int) -> None:
    """Every job completed or rejected, none lost; every completed engine
    job's trace conserves and has its configuration's phases."""
    if len(result.records) != n_jobs or any(
            not (r.completed or not r.admitted) for r in result.records):
        raise AssertionError(f"{tag}: jobs lost: {result.metrics()}")
    for r in result.records:
        if not r.completed:
            continue
        want = ["map"] + ["combine"] * r.plan.combiner + ["shuffle", "reduce"]
        bad = r.trace.check_conservation()
        got = [p for p in r.trace.phase_names() if p not in ("regrant", "suspended")]
        if bad or got != want:
            raise AssertionError(f"{tag} job {r.spec.job_id}: phases {got} (want {want}), {bad}")


def policy_line(tag: str, result, wall: float) -> str:
    m = result.metrics()
    admitted = [r for r in result.records if r.admitted]
    cuda = sum(r.plan.backend == "cuda" for r in admitted) / max(1, len(admitted))
    slo = "n/a" if m["slo_attainment"] is None else f"{m['slo_attainment']:.2f}"
    mae = "n/a" if m["pred_mae_pct"] is None else f"{m['pred_mae_pct']:.1f} %"
    return (f"{tag}: {m['n_completed']} of {m['n_jobs']} completed, {m['n_rejected']} rejected; "
            f"makespan {m['makespan_s'] * 1e3:.1f} ms, mean turnaround "
            f"{m['mean_turnaround_s'] * 1e3:.1f} ms, SLO attainment {slo}, "
            f"{cuda:.0%} planned on cuda, combiner {m['combiner_histogram']}, "
            f"online mean |pred - actual| / actual {mae} (paper's band 5 %); "
            f"{wall:.1f} s on the host")


def phase_cluster() -> dict:
    """The predictive scheduler on the live engine, on the card.

    One traced EngineOracle (size quantum 2**20) serves a trace of
    CLUSTER_JOBS jobs (sizes log-uniform over CLUSTER_SIZES, deadlines from
    the oracle's nominal time) on CLUSTER_WORKERS workers under
    predict-combine (backends torch and cuda, combiner off and on: it
    bootstraps the shared model database at BOOTSTRAP_SIZES), then
    predict-sjf and predict-deadline warm from that database, then
    fifo-static on cuda; then predict-elastic on an ElasticCluster with
    ELASTIC_JOBS jobs over ELASTIC_SIZES (three best-effort jobs first,
    deadline jobs a moment later), which must regrant at least once on measured
    snapshot walls; then the CLI once, in-process, with its own oracle
    (fifo-static on torch, so it launches no kernel).  Every job completes
    or is rejected, fifo-static completes all, every trace conserves.
    Returns the launches the oracle's cuda runs must have made."""
    import dataclasses as dc
    import tempfile

    from repro_torch.cluster import (Cluster, EngineOracle, assign_deadlines,
                                     generate_workload, get_policy)
    from repro_torch.core.predictor import ModelDatabase
    from repro_torch.elastic import ElasticCluster
    from repro_torch.launch import cluster as cli

    torch.cuda.reset_peak_memory_stats()
    want = {"segment_reduce": 0, "local_reduce": 0}
    walls = {"bootstrap": 0.0, "snapshots": []}
    oracle = EngineOracle(traced=True, size_quantum=1 << 20, device="cuda")
    tally_oracle(oracle, want, walls)
    jobs = generate_workload(CLUSTER_JOBS, seed=3, mean_interarrival=0.05,
                             size_range=CLUSTER_SIZES)
    jobs = assign_deadlines(jobs, lambda j: oracle.nominal_time(j.app, j.size),
                            slack_range=(1.5, 6.0), fraction=0.6, seed=4)
    db = ModelDatabase()
    arms = {"backends": ("torch", "cuda"), "db": db, "seed": 0,
            "bootstrap_sizes": BOOTSTRAP_SIZES}
    for name, kw in (("predict-combine", arms), ("predict-sjf", arms),
                     ("predict-deadline", arms),
                     ("fifo-static", {"backend": "cuda"})):
        t0 = time.perf_counter()
        result = Cluster(CLUSTER_WORKERS, oracle).run(jobs, get_policy(name, **kw))
        wall = time.perf_counter() - t0
        check_records(name, result, len(jobs))
        if name == "fifo-static" and result.metrics()["n_completed"] != len(jobs):
            raise AssertionError(f"fifo-static left jobs: {result.metrics()}")
        log("cluster", policy_line(name, result, wall))
        if name == "predict-combine":
            log("cluster", f"bootstrap: {len(db)} models (torch, cuda, torch+c, cuda+c per "
                f"app) in {walls['bootstrap']:.1f} s of profiled runs")

    # The elastic arm: best-effort jobs take the pool, deadline jobs arrive
    # while they run and predict-elastic shrinks one to admit them.
    base = generate_workload(ELASTIC_JOBS, seed=5, size_range=ELASTIC_SIZES)
    head = [dc.replace(j, arrival=0.0) for j in base[:3]]
    tail = assign_deadlines([dc.replace(j, arrival=1e-4 * (i + 1)) for i, j in
                             enumerate(base[3:])],
                            lambda j: oracle.nominal_time(j.app, j.size),
                            slack_range=(1.5, 3.0), fraction=1.0, seed=6)
    cluster = ElasticCluster(ELASTIC_WORKERS, oracle, snapshot_overhead_s=ELASTIC_PRIOR_S,
                             restore_overhead_s=ELASTIC_PRIOR_S)
    policy = get_policy("predict-elastic", **arms)
    n_snap, t0 = len(walls["snapshots"]), time.perf_counter()
    result = cluster.run(head + tail, policy)
    wall = time.perf_counter() - t0
    check_records("predict-elastic", result, ELASTIC_JOBS)
    m = result.metrics()
    log("cluster", "predict-elastic jobs: " + "; ".join(
        f"{r.spec.job_id} {'deadline' if r.spec.deadline else 'best-effort'} "
        f"{r.spec.size >> 20} Mi {r.plan.backend} ({r.plan.mappers}, {r.plan.reducers}, "
        f"{r.plan.workers}) {r.start * 1e3:.2f}-{r.finish * 1e3:.2f} ms, segments "
        + "/".join(str(w) for _, _, w in r.segments)
        for r in result.records if r.admitted))
    if m["n_regrants"] < 1:
        raise AssertionError(f"the elastic arm never regranted: {m}")
    snaps = walls["snapshots"][n_snap:]
    log("cluster", policy_line("predict-elastic (elastic)", result, wall)
        + f"; {m['n_regrants']} regrants ({policy.n_shrinks} shrinks, {policy.n_grows} grows), "
        f"charged {m['regrant_overhead_s'] * 1e3:.1f} ms; measured snapshot save / restore "
        + ", ".join(f"{s * 1e3:.1f} / {r * 1e3:.1f} ms" for s, r in snaps))

    # The CLI, once, with its own oracle.
    with tempfile.TemporaryDirectory() as tmp:
        out_json, trace_out = Path(tmp) / "m.json", Path(tmp) / "t.json"
        t0 = time.perf_counter()
        cli.main(["--oracle", "engine-traced", "--jobs", "8", "--workers", "16",
                  "--policies", "fifo-static", "--size-min", "4194304",
                  "--size-max", "16777216", "--json", str(out_json),
                  "--trace-out", str(trace_out)])
        wall = time.perf_counter() - t0
        m = json.loads(out_json.read_text())["fifo-static"]
        spans = [e for e in json.loads(trace_out.read_text())["traceEvents"]
                 if e.get("cat") == "job" and e.get("ph") == "X"]
        if m["n_completed"] != 8 or sorted(e["args"]["job_id"] for e in spans) != list(range(8)):
            raise AssertionError(f"CLI: {m['n_completed']} completed, job spans {len(spans)}")
    log("cluster", f"CLI --oracle engine-traced --jobs 8 --policies fifo-static: 8 completed, "
        f"span trace with one job span a job, makespan {m['makespan_s'] * 1e3:.1f} ms; "
        f"{wall:.1f} s on the host")
    log("cluster", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches wanted {want}")
    if min(want.values()) < 1:
        raise AssertionError(f"the cluster path planned no cuda work: {want}")
    return want


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
#: per (query, head) row: the norm of the difference over the norm of the
#: plain version's row.  A row that averages thousands of keys is small
#: (|out| about 0.01 at 32k keys), so the elementwise 5e-2 alone would pass
#: an all-zero output; this holds each row to its own scale.
ATTN_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
QWEN = dict(Hq=16, n_kv=8, hd=128)  # qwen3-0.6b attention geometry
GEMMA = dict(Hq=16, n_kv=16, hd=256)  # gemma-7b's: MHA, head_dim 256


def attention_bound(B, Sq, Hq, n_kv, hd, Sk, visible, itemsize=2):
    """(bound ms, bound_by): the larger of the operations the inputs need
    (QK^T and PV over the visible (query, key) pairs per head, at the bf16
    tensor-core peak) and the bytes (q read, out written, the keys read
    once, K and V) at the HBM rate."""
    flops = 4 * B * Hq * hd * visible
    nbytes = (2 * B * Sq * Hq * hd + 2 * B * Sk * n_kv * hd) * itemsize
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def attn_inputs(seed, dtype, *shapes):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=g, device="cuda").to(dtype) for s in shapes]


def attention_errs(got, want) -> tuple[float, float]:
    """(max abs err, max per-row relative err) of ``got`` against ``want``."""
    diff = got.float() - want.float()
    rows = diff.norm(dim=-1) / want.float().norm(dim=-1).clamp_min(1e-30)
    return float(diff.abs().max()), float(rows.max())


def check_attention(name, got, want, dtype, what) -> tuple[float, float]:
    """Holds a kernel's output against its plain version: elementwise to
    ATTN_TOL and row by row to ATTN_ROW_TOL; returns both errors."""
    torch.cuda.synchronize()
    err, row_err = attention_errs(got, want)
    tol = ATTN_TOL[dtype]
    if got.dtype != dtype or not torch.isfinite(got).all() or not torch.allclose(
            got.float(), want.float(), rtol=tol, atol=tol) or not row_err <= ATTN_ROW_TOL[dtype]:
        raise AssertionError(f"{name} differs from its plain version on {what} "
                             f"({dtype}): max abs err {err}, row err {row_err}")
    return err, row_err


def check_rejects(name, case, want, wrongs: dict) -> str:
    """Each wrong output must fail ``check_attention``: the check can tell
    a broken kernel at this shape.  Returns their row errors."""
    said = []
    for what, bad in wrongs.items():
        try:
            check_attention(name, bad, want, want.dtype, what)
        except AssertionError:
            said.append(f"{what}: row err {attention_errs(bad, want)[1]:.3f}")
            continue
        raise AssertionError(f"the {name} check passes a wrong output ({what}) on {case}")
    return "; ".join(said)


def wrong_outputs(q, k, v, ref, want, n_visible: int) -> dict:
    """Outputs of plausible kernel faults, from the plain version: all
    zeros; at decode (one query) one key split dropped from the combine;
    else the values of the last key tile (128 keys, 64 at head_dim 256)
    lost, whole or its first half."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_ref,
        split_plan,
        target_blocks,
        tile_keys,
    )

    wrongs = {"all-zero output": torch.zeros_like(want)}
    B, Sq, Hq, hd = q.shape
    if Sq == 1:
        n, keys = split_plan(B, Sq, Hq, k.shape[2], k.shape[1], n_visible,
                             target_blocks(q.device.index), hd)
        a = n // 2 * keys
        keep = torch.cat([torch.arange(a), torch.arange(a + keys, n_visible)]).to(k.device)
        wrongs[f"split {n // 2} of {n} dropped"] = decode_attention_ref(
            q, k[:, keep], v[:, keep], len(keep))
    else:
        tile = tile_keys(hd)
        lost = v.clone()
        lost[:, n_visible - tile:n_visible - tile // 2] = 0
        wrongs[f"{tile // 2} keys of values lost"] = ref(q, k, lost)
        lost[:, n_visible - tile // 2:n_visible] = 0
        wrongs[f"one {tile}-key tile of values lost"] = ref(q, k, lost)
    return wrongs


def phase_attention() -> dict:
    """flash_attention and decode_attention against their plain versions;
    returns the kernels-line numbers of the serving shapes (bfloat16)."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full float32
    Hq, n_kv, hd = QWEN["Hq"], QWEN["n_kv"], QWEN["hd"]
    errs = {"decode_attention": 0.0, "flash_attention": 0.0}

    # Edge cases, both dtypes.
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = attn_inputs(1, dtype, (1, 1, 2, 32), (1, 128, 2, 32), (1, 128, 2, 32))
        clean = decode_attention(q, k, v, 50)
        k[:, 50:], v[:, 50:] = 1e4, -1e4  # poison the unwritten slots
        got = decode_attention(q, k, v, 50)
        torch.cuda.synchronize()
        if not torch.equal(got, clean):
            raise AssertionError("decode_attention read cache slots past kv_len")
        check_attention("decode_attention", got, decode_attention_ref(q, k, v, 50), dtype,
                        "garbage past kv_len")
        q, k, v = attn_inputs(2, dtype, (2, 4, Hq, hd), (2, 100, n_kv, hd), (2, 100, n_kv, hd))
        e1, _ = check_attention("decode_attention", decode_attention(q, k, v, 102),
                                decode_attention_ref(q, k, v, 102), dtype,
                                "kv_len 102 > S_max 100")
        q, k, v = attn_inputs(3, dtype, (2, 100, 4, 32), (2, 100, 1, 32), (2, 100, 1, 32))
        e2, _ = check_attention("flash_attention", flash_attention(q, k, v, causal=True),
                                flash_attention_ref(q, k, v, causal=True), dtype, "ragged S 100")
        q, k, v = attn_inputs(4, dtype, (1, 64, 2, 80), (1, 192, 2, 80), (1, 192, 2, 80))
        e3, _ = check_attention("flash_attention", flash_attention(q, k, v, causal=False),
                                flash_attention_ref(q, k, v, causal=False), dtype,
                                "non-causal Sk 192 > Sq 64")
        log("attention", f"edge cases ({dtype}): garbage past kv_len ignored bit for bit; "
            f"kv_len > S_max err {e1:.2e}; ragged S=100 err {e2:.2e}; non-causal "
            f"Sk > Sq err {e3:.2e} (tolerance {ATTN_TOL[dtype]})")
        if dtype == torch.bfloat16:
            errs["decode_attention"] = max(errs["decode_attention"], e1)
            errs["flash_attention"] = max(errs["flash_attention"], e2, e3)

    # The serving shapes: (name, case, inputs, visible keys of the last
    # query, kernel, plain, library, bound).
    S_dec, S_pre, P_max, S_fl = 32768, 2048, 4096, 8192
    cases = [
        ("decode_attention", f"decode B=8 Sq=1 kv_len=S_max={S_dec}",
         ((8, 1, Hq, hd), (8, S_dec, n_kv, hd)), S_dec,
         lambda q, k, v: decode_attention(q, k, v, S_dec),
         lambda q, k, v: decode_attention_ref(q, k, v, S_dec),
         lambda q, k, v: F.scaled_dot_product_attention(
             q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), enable_gqa=True),
         attention_bound(8, 1, Hq, n_kv, hd, S_dec, S_dec)),
        ("decode_attention", f"prefill B=8 Sq=kv_len={S_pre} S_max={P_max}",
         ((8, S_pre, Hq, hd), (8, P_max, n_kv, hd)), S_pre,
         lambda q, k, v: decode_attention(q, k, v, S_pre),
         lambda q, k, v: decode_attention_ref(q, k, v, S_pre),
         lambda q, k, v: F.scaled_dot_product_attention(
             q.transpose(1, 2), k[:, :S_pre].transpose(1, 2), v[:, :S_pre].transpose(1, 2),
             is_causal=True, enable_gqa=True),
         attention_bound(8, S_pre, Hq, n_kv, hd, S_pre, S_pre * (S_pre + 1) // 2)),
        ("flash_attention", f"causal B=1 S={S_fl}",
         ((1, S_fl, Hq, hd), (1, S_fl, n_kv, hd)), S_fl,
         lambda q, k, v: flash_attention(q, k, v, causal=True),
         lambda q, k, v: flash_attention_ref(q, k, v, causal=True),
         lambda q, k, v: F.scaled_dot_product_attention(
             q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
             enable_gqa=True),
         attention_bound(1, S_fl, Hq, n_kv, hd, S_fl, S_fl * (S_fl + 1) // 2)),
    ]
    # gemma-7b's heads (16 of 256, MHA): its long-prompt prefill and a
    # causal and a non-causal (Sk > Sq) flash call; decode at batch 1 over
    # a ragged kv_len, where the keys split into 64-key tiles.
    gH, gkv, ghd = GEMMA["Hq"], GEMMA["n_kv"], GEMMA["hd"]
    kv_g, Sq_g, Sk_g = 30001, 2048, 4096
    cases += [
        ("decode_attention", f"gemma-7b decode B=1 Sq=1 kv_len={kv_g} S_max={S_dec}",
         ((1, 1, gH, ghd), (1, S_dec, gkv, ghd)), kv_g,
         lambda q, k, v: decode_attention(q, k, v, kv_g),
         lambda q, k, v: decode_attention_ref(q, k, v, kv_g),
         lambda q, k, v: F.scaled_dot_product_attention(
             q.transpose(1, 2), k[:, :kv_g].transpose(1, 2), v[:, :kv_g].transpose(1, 2)),
         attention_bound(1, 1, gH, gkv, ghd, kv_g, kv_g)),
        ("decode_attention", f"gemma-7b prefill B=8 Sq=kv_len={S_pre} S_max={P_max}",
         ((8, S_pre, gH, ghd), (8, P_max, gkv, ghd)), S_pre,
         lambda q, k, v: decode_attention(q, k, v, S_pre),
         lambda q, k, v: decode_attention_ref(q, k, v, S_pre),
         lambda q, k, v: F.scaled_dot_product_attention(
             q.transpose(1, 2), k[:, :S_pre].transpose(1, 2), v[:, :S_pre].transpose(1, 2),
             is_causal=True),
         attention_bound(8, S_pre, gH, gkv, ghd, S_pre, S_pre * (S_pre + 1) // 2)),
        ("flash_attention", f"gemma-7b causal B=1 S={S_fl}",
         ((1, S_fl, gH, ghd), (1, S_fl, gkv, ghd)), S_fl,
         lambda q, k, v: flash_attention(q, k, v, causal=True),
         lambda q, k, v: flash_attention_ref(q, k, v, causal=True),
         lambda q, k, v: F.scaled_dot_product_attention(
             q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True),
         attention_bound(1, S_fl, gH, gkv, ghd, S_fl, S_fl * (S_fl + 1) // 2)),
        ("flash_attention", f"gemma-7b non-causal B=1 Sq={Sq_g} Sk={Sk_g}",
         ((1, Sq_g, gH, ghd), (1, Sk_g, gkv, ghd)), Sk_g,
         lambda q, k, v: flash_attention(q, k, v, causal=False),
         lambda q, k, v: flash_attention_ref(q, k, v, causal=False),
         lambda q, k, v: F.scaled_dot_product_attention(
             q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
         attention_bound(1, Sq_g, gH, gkv, ghd, Sk_g, Sq_g * Sk_g)),
    ]
    report = {}
    for i, (name, case, (qs, ks), n_visible, kern, ref, lib,
            (bound_ms, bound_by)) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attn_inputs(10 + i, dtype, qs, ks, ks)
            want = ref(q, k, v)
            err, row_err = check_attention(name, kern(q, k, v), want, dtype, case)
            if dtype == torch.float32:
                log("attention", f"{name} {case} (float32): err {err:.2e}, row err "
                    f"{row_err:.2e} (tolerance 2e-5, rows 1e-4)")
                del q, k, v, want
                torch.cuda.empty_cache()
                continue
            rejected = check_rejects(name, case, want,
                                     wrong_outputs(q, k, v, ref, want, n_visible))
            log("attention", f"{name} {case} (bfloat16): the check rejects {rejected} "
                f"(output scale {float(want.float().abs().max()):.3f})")
            errs[name] = max(errs[name], err)
            ms = device_ms(lambda: kern(q, k, v), iters=50, warmup=10)
            plain_ms = device_ms(lambda: ref(q, k, v), iters=3, warmup=1)
            lib_out = lib(q, k, v).transpose(1, 2)
            lib_err = float((lib_out.float() - want.float()).abs().max())
            library_ms = device_ms(lambda: lib(q, k, v), iters=50, warmup=10)
            log("attention", f"{name} {case} (bfloat16): err {err:.2e}, row err "
                f"{row_err:.2e} (tolerance 5e-2, rows 1e-2); "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms "
                f"(SDPA vs plain err {lib_err:.2e}), bound {bound_ms:.4f} ms "
                f"({bound_by}; {bound_ms / ms:.0%} of it reached)")
            if name not in report:  # the first case of each kernel goes in the line
                report[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by, "library_ms": library_ms,
                                "shape": [list(qs), list(ks)]}
            del q, k, v, want, lib_out
            torch.cuda.empty_cache()
    for name in report:
        report[name]["max_abs_err"] = errs[name]
    return report


#: decode_step calls of one ``BatchedServer.token_latency`` at its default
#: repeats: a 4-token warm-up serve, then two serves of 8 tokens; a serve
#: of n new tokens is one prefill and n - 1 decode steps (launch/serve.py)
TOKEN_LATENCY_STEPS = 4 + 2 * 8


@contextlib.contextmanager
def attention_swapped(decode_fn, flash_fn):
    """Runs the kernel path (``use_flash=True``) with ``decode_fn`` and
    ``flash_fn`` in place of the two attention kernels."""
    from repro_torch.models import attention

    saved = attention.decode_attention, attention.flash_attention
    attention.decode_attention, attention.flash_attention = decode_fn, flash_fn
    try:
        yield
    finally:
        attention.decode_attention, attention.flash_attention = saved


def held_against_plain(stats: dict):
    """(decode_fn, flash_fn) for ``attention_swapped``: each launches its
    kernel, holds the output against the plain version on the same inputs
    (``check_attention``) and keeps (calls, max abs err, max row err) in
    ``stats``."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    def held(name, kern, ref):
        def call(*args, **kwargs):
            out = kern(*args, **kwargs)
            err, row_err = check_attention(name, out, ref(*args, **kwargs), out.dtype,
                                           "the model's activations")
            n, e, r = stats.get(name, (0, 0.0, 0.0))
            stats[name] = (n + 1, max(e, err), max(r, row_err))
            return out
        return call

    return (held("decode_attention", decode_attention, decode_attention_ref),
            held("flash_attention", flash_attention, flash_attention_ref))


def teacher_forced(model, cfg, tokens, n_prompt: int):
    """Kernel-path logits at positions n_prompt - 1 .. S - 1: a prefill of
    n_prompt tokens through decode_step, then one decode step per token,
    with a float32 cache.  Makes 1 + S - n_prompt decode_step calls."""
    from repro_torch.models import transformer as tf

    B, S = tokens.shape
    state = tf.init_decode_state(cfg, B, S, cache_dtype=torch.float32,
                                 device=tokens.device)
    logits, state = tf.decode_step(model, cfg, state, {"tokens": tokens[:, :n_prompt]},
                                   use_flash=True)
    out = [logits[:, -1]]
    for i in range(n_prompt, S):
        logits, state = tf.decode_step(model, cfg, state, {"tokens": tokens[:, i:i + 1]},
                                       use_flash=True)
        out.append(logits[:, 0])
    return torch.stack(out, dim=1)


def logits_err(a, b, V: int) -> tuple[float, float]:
    """(max abs err, relative norm of the difference) over the vocabulary."""
    a, b = a[..., :V].float(), b[..., :V].float()
    return float((a - b).abs().max()), float((a - b).norm() / b.norm())


def phase_serve(arch: str = "qwen3-0.6b", tag: str = "serve", requests: int = 32,
                long_new: int = 128) -> dict:
    """The LM serving path of ``arch`` at full width; returns the attention
    launches it made, counted from zero at its start and held against the
    calls it drives: one per layer for each decode_step call and each
    forward call of the kernel path.  ``requests`` 8-token prompts are
    served at the SLO batch, then 8 2048-token prompts with ``long_new``
    new tokens into a 4096-slot cache."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import transformer as tf
    from repro_torch.train import StepConfig, build_eval_step

    cfg = get_config(arch)
    V = cfg.vocab_size
    decode_attention.launches = 0
    flash_attention.launches = 0
    steps = forwards = 0  # decode_step and forward calls of the kernel path
    t0 = time.perf_counter()
    model = tf.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(tag, f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, vocab "
        f"{cfg.vocab_size}; {n_bytes / 1e9:.3f} GB of bf16 weights drawn on the card "
        f"in {time.perf_counter() - t0:.1f} s")

    # launch/serve.py:main: profile, fit, pick the SLO batch, serve 32 requests.
    server = BatchedServer(cfg, model)
    latency = server.profile_latency_model()
    steps += len(server.profiled) * TOKEN_LATENCY_STEPS
    for b, t in server.profiled.items():
        log(tag, f"profile batch {b}: {t * 1e3:.3f} ms/token")
    batch = server.pick_batch_for_slo(latency, 50e-3)
    log(tag, f"fit: train MAPE {latency.train_mape:.2f}%, R^2 {latency.r2:.4f}; "
        f"SLO 50 ms/token -> predicted max batch {batch}")
    done, g = 0, torch.Generator(device="cuda")
    while done < requests:
        b = min(batch, requests - done)
        prompts = torch.randint(0, cfg.vocab_size, (b, 8), generator=g.manual_seed(done),
                                device="cuda")
        toks, per_tok = server.serve(prompts, 16)
        steps += 16
        if toks.shape != (b, 16) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
            raise AssertionError(f"served tokens out of range: {tuple(toks.shape)}")
        done += b
        log(tag, f"served {b} requests of 8-token prompts, 16 new tokens: "
            f"{per_tok * 1e3:.3f} ms/token, prefill {server.last_prefill_s * 1e3:.2f} ms "
            f"({done}/{requests} done)")

    # The model at batches it was not profiled at.
    pred = latency.predict(np.asarray([[3.0], [6.0]]), device="cuda").cpu().numpy()
    for b, p in zip((3, 6), pred):
        m = server.token_latency(b)
        steps += TOKEN_LATENCY_STEPS
        log(tag, f"batch {b}: predicted {p * 1e3:.3f} ms/token, measured "
            f"{m * 1e3:.3f} ms/token ({(p - m) / m:+.1%})")

    # One batch of 8 long prompts.
    long_server = BatchedServer(cfg, model, max_len=4096)
    prompts = torch.randint(0, cfg.vocab_size, (8, 2048), generator=g.manual_seed(7),
                            device="cuda")
    long_server.serve(prompts[:, :64], 4)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    toks, per_tok = long_server.serve(prompts, long_new)
    steps += 4 + long_new
    log(tag, f"8 requests of 2048-token prompts, max_len 4096 (KV cache "
        f"{8 * 4096 * cfg.n_layers * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2 / 1e9:.2f}"
        f" GB), {long_new} new tokens: prefill {long_server.last_prefill_s * 1e3:.1f} ms "
        f"({8 * 2048 / long_server.last_prefill_s:.0f} tokens/s), decode "
        f"{per_tok * 1e3:.3f} ms/token; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if toks.shape != (8, long_new):
        raise AssertionError(f"long-prompt batch returned {tuple(toks.shape)}")
    prefills = []
    for _ in range(3):  # the prefill alone: serve one token
        long_server.serve(prompts, 1)
        prefills.append(long_server.last_prefill_s)
    steps += 3
    log(tag, f"prefill of the same 8 x 2048-token prompts, three more times: "
        f"{', '.join(f'{t * 1e3:.1f}' for t in prefills)} ms")
    profiled_breakdown(f"{cfg.name} prefill of the 8 x 2048-token prompts",
                       lambda: long_server.serve(prompts, 1))
    steps += 1
    del long_server
    torch.cuda.empty_cache()

    # The kernel path on a 24-token prompt: forward, and prefill + decode
    # steps through decode_step, every kernel call held against its plain
    # version on the same inputs.  Then the 28-layer logits against the same
    # path with the plain versions (float32 scores and p, as the kernels);
    # against the plain versions with the softmax scale moved by 2^-20, the
    # floor to which the bf16 model amplifies any sub-ulp difference; and
    # against the plain path (use_flash=False: _sdpa rounds the scores and p
    # to bf16).
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention_ref

    plain_versions = (decode_attention_ref, flash_attention_ref)
    nudged = (decode_attention_ref, functools.partial(
        flash_attention_ref, sm_scale=(1 + 2**-20) * cfg.resolved_head_dim**-0.5))
    held: dict = {}
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen, device="cuda")
    with attention_swapped(*held_against_plain(held)):
        full, _ = tf.forward(model, cfg, {"tokens": tokens}, use_flash=True)
        dec = teacher_forced(model, cfg, tokens, 16)
    forwards, steps = forwards + 1, steps + 9
    with attention_swapped(*plain_versions):
        full_ref, _ = tf.forward(model, cfg, {"tokens": tokens}, use_flash=True)
        dec_ref = teacher_forced(model, cfg, tokens, 16)
    with attention_swapped(*nudged):
        floor, _ = logits_err(tf.forward(model, cfg, {"tokens": tokens}, use_flash=True)[0],
                              full_ref, V)
    plain, _ = tf.forward(model, cfg, {"tokens": tokens}, use_flash=False)
    # Decode vs forward: 2e-2 (tests/test_models_smoke.py), or twice what
    # the same model gives with the kernels' plain versions where the rest
    # of the bf16 model already differs more (gemma-7b: cuBLAS takes other
    # GEMMs at 2 rows than at 48, and 28 layers amplify the roundings); the
    # float32 upcast below is held to 2e-2 without that floor.
    err_dec, _ = logits_err(dec, full[:, 15:], V)
    floor_dec, _ = logits_err(dec_ref, full_ref[:, 15:], V)
    tol_dec = max(2e-2, 2 * floor_dec)
    if not torch.allclose(dec[..., :V].float(), full[:, 15:, :V].float(), rtol=2e-2,
                          atol=tol_dec):
        raise AssertionError(f"decode_step differs from forward: max abs err {err_dec}, "
                             f"{floor_dec} with the plain versions")
    err_full, rel_full = logits_err(full, full_ref, V)
    err_step, _ = logits_err(dec, dec_ref, V)
    limit = max(5e-2, 2 * floor)
    if not (err_full <= limit and err_step <= limit and rel_full <= 5e-2):
        raise AssertionError(f"kernel-path logits differ from the kernels' plain versions: "
                             f"forward {err_full}, decode_step {err_step}, floor {floor}")
    err_plain, rel_plain = logits_err(full, plain, V)
    err_ref_plain, rel_ref_plain = logits_err(full_ref, plain, V)
    if not rel_plain <= 5e-2:
        raise AssertionError(f"kernel-path logits differ from the plain path: "
                             f"relative norm {rel_plain}")
    log(tag, f"prefill 16 + 8 decode steps (f32 cache) == forward at each position: "
        f"max abs err {err_dec:.3e} (tolerance {tol_dec:.3g}; the plain versions' path "
        f"{floor_dec:.3e}), logits scale {float(full[..., :V].float().abs().max()):.2f}")
    log(tag, "each attention call of that run vs its plain version on the same inputs: "
        + "; ".join(f"{name} {n} calls, max abs err {e:.3e}, row err {r:.3e}"
                    for name, (n, e, r) in sorted(held.items()))
        + " (tolerance 5e-2, rows 1e-2)")
    log(tag, f"{cfg.n_layers}-layer logits, kernels vs their plain versions on the "
        f"same path: forward max abs err {err_full:.3e} (relative norm {rel_full:.3e}), "
        f"prefill + decode steps {err_step:.3e}; plain versions vs themselves with the "
        f"softmax scale moved by 2^-20: {floor:.3e} (tolerance max(5e-2, 2 x that))")
    log(tag, f"{cfg.n_layers}-layer forward logits vs the plain path (_sdpa): kernels "
        f"max abs err {err_plain:.3e}, relative norm {rel_plain:.3e} (tolerance 5e-2); "
        f"the kernels' plain versions max abs err {err_ref_plain:.3e}, relative norm "
        f"{rel_ref_plain:.3e}")
    del full, full_ref, dec, dec_ref, plain
    float32_path(model, cfg, tokens, tag, plain_versions)
    forwards, steps = forwards + 1, steps + 9

    # Scoring at 2048 tokens: every kernel call held against its plain
    # version, the logits against the plain versions' path (with its floor),
    # and the eval loss against the plain path.
    held.clear()
    seq = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    with attention_swapped(*held_against_plain(held)):
        got, _ = tf.forward(model, cfg, {"tokens": seq}, use_flash=True)
    forwards += 1
    with attention_swapped(*plain_versions):
        want, _ = tf.forward(model, cfg, {"tokens": seq}, use_flash=True)
    with attention_swapped(*nudged):
        floor_long, _ = logits_err(tf.forward(model, cfg, {"tokens": seq}, use_flash=True)[0],
                                   want, V)
    err_long, rel_long = logits_err(got, want, V)
    del got, want
    n, e, r = held["flash_attention"]
    if not (err_long <= max(5e-2, 2 * floor_long) and rel_long <= 5e-2):
        raise AssertionError(f"2048-token logits differ from the kernels' plain versions: "
                             f"{err_long}, floor {floor_long}")
    log(tag, f"2048-token scoring: {n} flash_attention calls vs their plain versions "
        f"max abs err {e:.3e}, row err {r:.3e}; logits vs the plain versions' path max abs "
        f"err {err_long:.3e} (relative norm {rel_long:.3e}), floor {floor_long:.3e}")
    loss = float(build_eval_step(cfg, StepConfig(use_flash=True, logits_chunk=512))(
        model, {"tokens": seq}))
    forwards += 1
    ref = float(build_eval_step(cfg, StepConfig(logits_chunk=512))(model, {"tokens": seq}))
    if not (math.isfinite(loss) and abs(loss - ref) <= 2e-2):
        raise AssertionError(f"scoring loss {loss} vs plain {ref}")
    log(tag, f"2048-token scoring loss {loss:.5f}, plain path {ref:.5f} "
        f"(|diff| {abs(loss - ref):.2e}, tolerance 2e-2)")
    score = build_eval_step(cfg, StepConfig(use_flash=True, logits_chunk=512))
    walls = []
    for _ in range(4):  # a warm-up, then three timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score(model, {"tokens": seq})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    forwards += 4
    log(tag, f"2048-token scoring time (eval step, kernel path, fenced): "
        f"{', '.join(f'{w * 1e3:.2f}' for w in walls[1:])} ms")

    launches = {"decode_attention": decode_attention.launches,
                "flash_attention": flash_attention.launches}
    want = {"decode_attention": cfg.n_layers * steps, "flash_attention": cfg.n_layers * forwards}
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, want {want} ({cfg.n_layers} per "
                             f"call: {steps} decode_step, {forwards} forward calls)")
    log("launches", f"{tag} path ({cfg.name}): decode_attention "
        f"{launches['decode_attention']} "
        f"({cfg.n_layers} x {steps} decode_step calls), flash_attention "
        f"{launches['flash_attention']} ({cfg.n_layers} x {forwards} forward calls)")
    serve_breakdown(server)
    return launches


def float32_path(model, cfg, tokens, tag: str, plain_versions) -> None:
    """The full-depth model with the same weights upcast to float32, where
    no bf16 rounding is amplified: a forward and a prefill of 16 + 8
    decode steps on the kernel path (each attention call held against its
    plain version at the float32 tolerance), decode vs forward to 2e-2
    (tests/test_models_smoke.py) and the kernel path against the plain
    versions' path to 5e-2.  Makes 9 decode_step and 1 forward call of
    the kernel path."""
    import dataclasses

    from repro_torch.models import transformer as tf

    V = cfg.vocab_size
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    model32 = tf.Transformer(cfg32, device=tokens.device)
    model32.load_state_dict(model.state_dict())
    held: dict = {}
    with attention_swapped(*held_against_plain(held)):
        full, _ = tf.forward(model32, cfg32, {"tokens": tokens}, use_flash=True)
        dec = teacher_forced(model32, cfg32, tokens, 16)
    with attention_swapped(*plain_versions):
        full_ref, _ = tf.forward(model32, cfg32, {"tokens": tokens}, use_flash=True)
        dec_ref = teacher_forced(model32, cfg32, tokens, 16)
    err_dec, rel_dec = logits_err(dec, full[:, 15:], V)
    err_full, rel_full = logits_err(full, full_ref, V)
    err_step, _ = logits_err(dec, dec_ref, V)
    log(tag, f"{cfg.n_layers} layers upcast to float32: prefill 16 + 8 decode steps vs "
        f"forward max abs err {err_dec:.3e} (relative norm {rel_dec:.3e}; tolerance 2e-2); "
        f"kernel vs plain versions' path: forward {err_full:.3e} (relative norm "
        f"{rel_full:.3e}), decode steps {err_step:.3e} (tolerance 5e-2); " + "; ".join(
            f"{name} {n} calls held, max abs err {e:.3e}, row err {r:.3e}"
            for name, (n, e, r) in sorted(held.items())) + " (tolerance 2e-5, rows 1e-4)")
    if not torch.allclose(dec[..., :V], full[:, 15:, :V], rtol=2e-2, atol=2e-2):
        raise AssertionError(f"float32: decode_step differs from forward by {err_dec}")
    if not (err_full <= 5e-2 and err_step <= 5e-2):
        raise AssertionError(f"float32: kernel-path logits differ from the plain versions' "
                             f"path: forward {err_full}, decode_step {err_step}")
    del model32, full, full_ref, dec, dec_ref
    torch.cuda.empty_cache()


def profiled_breakdown(what: str, fn) -> None:
    """Runs ``fn()`` once under torch.profiler; logs its wall time, the
    device's busy time and share, the launches and the longest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            entry = by_kernel.setdefault(evt.name, [0.0, 0])
            entry[0] += evt.time_range.elapsed_us()
            entry[1] += 1
    busy = sum(us for us, _ in by_kernel.values())
    n = sum(c for _, c in by_kernel.values())
    log("breakdown", f"{what}, under torch.profiler: wall {wall_us / 1e3:.3f} ms, device "
        f"busy {busy / 1e3:.3f} ms ({busy / wall_us:.0%}), {n} kernel launches")
    for kname, (us, c) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]:
        log("breakdown", f"  {us / 1e3:8.3f} ms  {c:4d}x  {kname[:90]}")


def serve_breakdown(server) -> None:
    """One batch-8 decode step at 512 cached tokens under torch.profiler."""
    from repro_torch.models import transformer as tf

    cfg = server.cfg
    state = tf.init_decode_state(cfg, 8, 1024, device="cuda")
    tok = torch.zeros((8, 512), dtype=torch.int64, device="cuda")
    _, state = server.decode(server.model, state, {"tokens": tok})
    step = {"tokens": tok[:, :1]}
    for _ in range(3):
        server.decode(server.model, state, step)
    profiled_breakdown(f"{cfg.name} decode step, batch 8, 512 cached tokens",
                       lambda: server.decode(server.model, state, step))


#: WKV6 output and final state against the plain version: elementwise at
#: the tolerance of tests/test_kernels.py::TestWKV6, and per row (one
#: (token, head) of out, one key row of S) relative to the row's norm
WKV6_TOL, WKV6_ROW_TOL = 2e-3, 1e-2
#: H100 SXM dense TF32 tensor-core peak (NVIDIA data sheet), over three:
#: the WKV6 kernels run every product as 3xTF32 (three TF32 products)
TF32X3_FLOPS = 495e12 / 3
RWKV = dict(H=40, hs=64)  # rwkv6-3b's heads


def wkv6_bound(B, T, H, hs, itemsize) -> dict:
    """The bound of one WKV6 call: the larger of the operations the
    function needs, the step recurrence's 5 hs^2 + 5 hs flops per (token,
    head) (r S; diag(w) S + k v^T; the bonus term) at 3xTF32's tensor-core
    rate, the units that run them, and the bytes (r, k, v in their dtype,
    w float32 read once, u and the initial state read, out float32 and the
    final state written) at the HBM rate; both terms are returned.  The
    tensor-core flops and the special-function operations (exp, log) that
    the kernel pair runs are information, not part of the bound."""
    tokens = B * T * H
    flops = tokens * (5 * hs * hs + 5 * hs)
    nbytes = tokens * hs * (3 * itemsize + 4 + 4) + H * hs * 4 + 2 * B * H * hs * hs * 4
    t_ops, t_bytes = flops / TF32X3_FLOPS, nbytes / HBM_BYTES_PER_S
    # Per chunk of 64 steps: the state update and the inter part, C hs^2
    # multiply-adds each; A's blocks below the diagonal (3072 hs), inside
    # the sub-chunks (512 hs) and A V (5120 hs).  Exps and logs: the cumsum
    # and the decayed k of each 32-column slice of the state, and 560 hs in
    # the outputs kernel.
    C, n = 64, B * H * math.ceil(T / 64)
    kernel_flops = n * (4 * C * hs * hs + (3072 + 512 + 5120) * hs)
    sfu = n * (math.ceil(hs / 32) * (2 * C + 4) * hs + 560 * hs)
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bound_ops_ms": t_ops * 1e3, "bound_bytes_ms": t_bytes * 1e3,
            "kernel_flops": kernel_flops, "sfu_ops": sfu}


def wkv6_inputs(seed, B, T, H, hs, dtype, *, w_range=(0.05, 0.999), with_state=True):
    """r, k, v (dtype), w, u and the initial state (float32) on the card,
    drawn as tests/test_kernels.py::TestWKV6 draws them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (B, T, H, hs)
    r = torch.randn(shape, generator=g, device="cuda").to(dtype)
    k = (torch.randn(shape, generator=g, device="cuda") * 0.5).to(dtype)
    v = torch.randn(shape, generator=g, device="cuda").to(dtype)
    lo, hi = w_range
    w = torch.rand(shape, generator=g, device="cuda") * (hi - lo) + lo
    u = torch.randn((H, hs), generator=g, device="cuda") * 0.3
    S0 = torch.randn((B, H, hs, hs), generator=g, device="cuda") * 0.5 if with_state else None
    return r, k, v, w, u, S0


def check_wkv6(got, want, what) -> tuple[float, float]:
    """Holds (out, S_T) of the kernel against the plain version's:
    elementwise to WKV6_TOL and row by row to WKV6_ROW_TOL; returns the
    largest errors."""
    torch.cuda.synchronize()
    errs = [attention_errs(g, w) for g, w in zip(got, want)]
    err, row_err = max(e for e, _ in errs), max(r for _, r in errs)
    for g, w in zip(got, want):
        if g.dtype != w.dtype or not torch.isfinite(g).all() or not torch.allclose(
                g.float(), w.float(), rtol=WKV6_TOL, atol=WKV6_TOL) or not row_err <= WKV6_ROW_TOL:
            raise AssertionError(f"wkv6 differs from its plain version on {what}: max abs "
                                 f"err {err}, row err {row_err}")
    return err, row_err


def wkv6_wrong_outputs(r, k, v, w, u, S0, chunk=64) -> dict:
    """Outputs of plausible kernel faults, from the plain version: the
    initial state ignored, the bonus diagonal dropped, and the state
    update of the chunk in the middle of the sequence lost."""
    from repro_torch.kernels.rwkv6 import wkv6_chunked_ref

    ref = functools.partial(wkv6_chunked_ref, chunk=chunk, out_dtype=torch.float32)
    a = r.shape[1] // chunk // 2 * chunk
    first, S_a = ref(r[:, :a], k[:, :a], v[:, :a], w[:, :a], u, state=S0)
    b = a + chunk
    lost, _ = ref(r[:, a:b], k[:, a:b], v[:, a:b], w[:, a:b], u, state=S_a)
    rest, S_T = ref(r[:, b:], k[:, b:], v[:, b:], w[:, b:], u, state=S_a)
    return {"initial state ignored": ref(r, k, v, w, u),
            "bonus diagonal dropped": ref(r, k, v, w, torch.zeros_like(u), state=S0),
            f"state update of chunk {a // chunk} lost": (torch.cat([first, lost, rest], 1), S_T)}


def phase_wkv6() -> dict:
    """The WKV6 kernel pair against its plain version on the card; returns
    the kernels-line numbers of the serving shape."""
    from repro_torch.kernels.rwkv6 import wkv6, wkv6_chunked_ref

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full float32
    H, hs = RWKV["H"], RWKV["hs"]
    err_max = 0.0
    # tests/test_kernels.py::TestWKV6's cases, float32, zero state; then strong decay.
    cases = [((2, 64, 2, 32), 16, {}), ((1, 100, 4, 64), 32, {}), ((2, 32, 1, 16), 32, {}),
             ((1, 128, 2, 64), 64, {}), ((1, 64, 1, 16), 16, {"w_range": (1e-6, 1e-6)})]
    for i, (shape, chunk, kw) in enumerate(cases):
        r, k, v, w, u, _ = wkv6_inputs(20 + i, *shape, torch.float32, with_state=False, **kw)
        what = f"{shape} chunk {chunk}" + (" w = 1e-6" if kw else "")
        e, re_ = check_wkv6(wkv6(r, k, v, w, u, chunk=chunk),
                            wkv6_chunked_ref(r, k, v, w, u, chunk=chunk), what)
        err_max = max(err_max, e)
        log("wkv6", f"{what} (float32): err {e:.2e}, row err {re_:.2e} (tolerance 2e-3, "
            "rows 1e-2)")

    # The serving long-prompt batch, one scoring sequence and one long
    # sequence, bf16 r, k, v, float32 out (the model path), a non-zero
    # initial state; then the serving batch with w at its 1e-8 clamp.
    report = {}
    for i, B_T in enumerate(((8, 2048), (1, 2048), (1, 32768))):
        shape = (*B_T, H, hs)
        r, k, v, w, u, S0 = wkv6_inputs(30 + i, *shape, torch.bfloat16)
        kern = lambda: wkv6(r, k, v, w, u, state=S0, out_dtype=torch.float32)
        ref = lambda: wkv6_chunked_ref(r, k, v, w, u, state=S0, out_dtype=torch.float32)
        want = ref()
        e, re_ = check_wkv6(kern(), want, f"{shape} bf16")
        err_max = max(err_max, e)
        if i == 0:
            said = []
            for what, bad in wkv6_wrong_outputs(r, k, v, w, u, S0).items():
                try:
                    check_wkv6(bad, want, what)
                except AssertionError:
                    said.append(f"{what}: row err {max(attention_errs(b, g)[1] for b, g in zip(bad, want)):.3f}")
                    continue
                raise AssertionError(f"the wkv6 check passes a wrong output ({what})")
            log("wkv6", f"{shape} bf16: the check rejects " + "; ".join(said))
        del want
        ms = device_ms(kern)
        plain_ms = device_ms(ref, iters=3, warmup=1)
        bound = wkv6_bound(*shape, 2)
        log("wkv6", f"{shape} bf16 r, k, v, non-zero state: err {e:.2e}, row err {re_:.2e} "
            f"(tolerance 2e-3, rows 1e-2); kernel pair {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: the step recurrence's "
            f"flops at 3xTF32's 165 TFLOP/s {bound['bound_ops_ms']:.4f} ms, bytes at 3.35 TB/s "
            f"{bound['bound_bytes_ms']:.4f} ms; {bound['bound_ms'] / ms:.0%} of it reached); "
            f"the pair does {bound['kernel_flops'] / 1e9:.3f} GFLOP on tensor cores (each as "
            f"3xTF32) and {bound['sfu_ops'] / 1e9:.3f} G exps and logs; library call: none")
        if i == 0:
            report["wkv6"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                              "shape": list(shape), "bound_ms": bound["bound_ms"],
                              "bound_by": bound["bound_by"]}
        del r, k, v, w, u, S0
        torch.cuda.empty_cache()

    # At the clamp the float32 plain version's cumulative logs (near -1180)
    # carry an ulp of 1.2e-4, which puts it about 3e-3 from float64: the
    # kernels are held against the same chunked form computed in float64.
    shape = (8, 2048, H, hs)
    r, k, v, w, u, S0 = wkv6_inputs(33, *shape, torch.bfloat16, w_range=(1e-8, 1e-8))
    got = wkv6(r, k, v, w, u, state=S0, out_dtype=torch.float32)
    exact = wkv6_chunked_ref(r, k, v, w, u, state=S0, out_dtype=torch.float32,
                             precision=torch.float64)
    e, re_ = check_wkv6(got, exact, f"{shape} bf16 w = 1e-8")
    err_max = max(err_max, e)
    plain = wkv6_chunked_ref(r, k, v, w, u, state=S0, out_dtype=torch.float32)
    plain_e = max(float((p - x).abs().max()) for p, x in zip(plain, exact))
    log("wkv6", f"{shape} bf16, w = 1e-8 (the clamp; a chunk's cumulative log reaches "
        f"{64 * math.log(1e-8):.0f}): out and state finite; against the chunked form in "
        f"float64 err {e:.2e}, row err {re_:.2e} (the float32 plain version's err there "
        f"{plain_e:.2e})")
    del r, k, v, w, u, S0, got, exact, plain
    torch.cuda.empty_cache()
    report["wkv6"]["max_abs_err"] = err_max
    return report


@contextlib.contextmanager
def wkv6_swapped(fn):
    """Runs the model with ``fn`` in place of the WKV6 kernel."""
    from repro_torch.models import ssm

    saved = ssm.wkv6
    ssm.wkv6 = fn
    try:
        yield
    finally:
        ssm.wkv6 = saved


def wkv6_held(stats: dict, kernel=None):
    """A stand-in for the kernel that launches it (``kernel``, default the
    wrapper), holds its output against the plain version on the same inputs
    (``check_wkv6``) and keeps (calls, max abs err, max row err) in
    ``stats``."""
    from repro_torch.kernels.rwkv6 import wkv6, wkv6_chunked_ref

    kernel = kernel or wkv6

    def call(*args, **kwargs):
        got = kernel(*args, **kwargs)
        err, row_err = check_wkv6(got, wkv6_chunked_ref(*args, **kwargs),
                                  "the model's activations")
        n, e, r = stats.get("wkv6", (0, 0.0, 0.0))
        stats["wkv6"] = (n + 1, max(e, err), max(r, row_err))
        return got
    return call


def wkv6_counted(hist: dict):
    """The wrapper, counting its calls by (B, T) in ``hist``."""
    from repro_torch.kernels.rwkv6 import wkv6

    def call(r, *args, **kwargs):
        key = tuple(r.shape[:2])
        hist[key] = hist.get(key, 0) + 1
        return wkv6(r, *args, **kwargs)
    return call


def phase_rwkv() -> dict:
    """The rwkv6-3b serving and scoring path at full width; returns the
    wkv6 launches it made, counted from zero at its start and held against
    the calls it drives: 32 per decode_step and forward call of S > 1
    tokens, none at S = 1.  The calls are also counted by (B, T), and the
    kernel pair is timed at each of those shapes."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6 import wkv6, wkv6_chunked_ref
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import transformer as tf
    from repro_torch.train import StepConfig, build_eval_step

    cfg = get_config("rwkv6-3b")
    V, L = cfg.vocab_size, cfg.n_layers
    wkv6.launches = 0
    calls = 0  # decode_step and forward calls of S > 1 tokens
    by_shape: dict = {}
    counted = wkv6_counted(by_shape)
    main_path = contextlib.ExitStack()
    main_path.enter_context(wkv6_swapped(counted))
    t0 = time.perf_counter()
    model = tf.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log("rwkv", f"{cfg.name}: {L} layers, d_model {cfg.d_model}, {cfg.d_model // cfg.rwkv_head_size}"
        f" heads of {cfg.rwkv_head_size}, d_ff {cfg.d_ff}, vocab {V}; {n_bytes / 1e9:.3f} GB of "
        f"bf16 weights drawn on the card in {time.perf_counter() - t0:.1f} s")

    # launch/serve.py:main: profile, fit, pick the SLO batch, serve 32 requests.
    server = BatchedServer(cfg, model)
    latency = server.profile_latency_model()
    calls += len(server.profiled) * 3  # a prefill per serve: warm-up and two repeats
    for b, t in server.profiled.items():
        log("rwkv", f"profile batch {b}: {t * 1e3:.3f} ms/token")
    batch = server.pick_batch_for_slo(latency, 50e-3)
    log("rwkv", f"fit: train MAPE {latency.train_mape:.2f}%, R^2 {latency.r2:.4f}; "
        f"SLO 50 ms/token -> predicted max batch {batch}")
    done, g = 0, torch.Generator(device="cuda")
    while done < 32:
        b = min(batch, 32 - done)
        prompts = torch.randint(0, V, (b, 8), generator=g.manual_seed(done), device="cuda")
        toks, per_tok = server.serve(prompts, 16)
        calls += 1
        if toks.shape != (b, 16) or int(toks.min()) < 0 or int(toks.max()) >= V:
            raise AssertionError(f"served tokens out of range: {tuple(toks.shape)}")
        done += b
        log("rwkv", f"served {b} requests of 8-token prompts, 16 new tokens: "
            f"{per_tok * 1e3:.3f} ms/token, prefill {server.last_prefill_s * 1e3:.2f} ms "
            f"({done}/32 done)")
    pred = latency.predict(np.asarray([[3.0], [6.0]]), device="cuda").cpu().numpy()
    for b, p in zip((3, 6), pred):
        m = server.token_latency(b)
        calls += 3
        log("rwkv", f"batch {b}: predicted {p * 1e3:.3f} ms/token, measured "
            f"{m * 1e3:.3f} ms/token ({(p - m) / m:+.1%})")

    # One batch of 8 long prompts.
    prompts = torch.randint(0, V, (8, 2048), generator=g.manual_seed(7), device="cuda")
    server.serve(prompts[:, :64], 4)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    toks, per_tok = server.serve(prompts, 128)
    calls += 2
    log("rwkv", f"8 requests of 2048-token prompts, 128 new tokens: prefill "
        f"{server.last_prefill_s * 1e3:.1f} ms ({8 * 2048 / server.last_prefill_s:.0f} tokens/s), "
        f"decode {per_tok * 1e3:.3f} ms/token; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if toks.shape != (8, 128):
        raise AssertionError(f"long-prompt batch returned {tuple(toks.shape)}")
    del prompts, toks
    torch.cuda.empty_cache()

    # 160 tokens (two chunks and a ragged third): forward, and a prefill of
    # 128 through decode_step then 32 single steps, each wkv6 call held
    # against its plain version.  Then the 32-layer logits against the same
    # path with the plain version, and that path against itself with w
    # moved by 2^-20 (a float32-sized change): the floor to which the bf16
    # model amplifies any sub-ulp difference.
    plain = wkv6_chunked_ref
    nudged = lambda r, k, v, w, u, **kw: wkv6_chunked_ref(r, k, v, w * (1 - 2**-20), u, **kw)
    held: dict = {}
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, V, (2, 160), generator=gen, device="cuda")
    with wkv6_swapped(wkv6_held(held, counted)):
        full, _ = tf.forward(model, cfg, {"tokens": tokens})
        dec = teacher_forced(model, cfg, tokens, 128)
    calls += 2
    with wkv6_swapped(plain):
        full_ref, _ = tf.forward(model, cfg, {"tokens": tokens})
        dec_ref = teacher_forced(model, cfg, tokens, 128)
    with wkv6_swapped(nudged):
        floor, floor_rel = logits_err(tf.forward(model, cfg, {"tokens": tokens})[0], full_ref, V)
    err_dec, rel_dec = logits_err(dec, full[:, 127:], V)
    err_dec_ref, _ = logits_err(dec_ref, full_ref[:, 127:], V)
    limit, limit_rel = max(5e-2, 2 * floor), max(5e-2, 2 * floor_rel)
    if not (err_dec <= max(2e-2, 2 * floor) and rel_dec <= limit_rel):
        raise AssertionError(f"decode_step differs from forward: {err_dec} (relative norm "
                             f"{rel_dec}), floor {floor} ({floor_rel})")
    err_full, rel_full = logits_err(full, full_ref, V)
    err_step, rel_step = logits_err(dec, dec_ref, V)
    if not (err_full <= limit and err_step <= limit and max(rel_full, rel_step) <= limit_rel):
        raise AssertionError(f"kernel-path logits differ from the plain version's: forward "
                             f"{err_full} ({rel_full}), decode_step {err_step} ({rel_step}), "
                             f"floor {floor} ({floor_rel})")
    n, e, r = held["wkv6"]
    log("rwkv", f"prefill 128 + 32 decode steps (f32 state) vs forward at each position: max "
        f"abs err {err_dec:.3e}, relative norm {rel_dec:.3e} (the plain version's path: "
        f"{err_dec_ref:.3e}; tolerance max(2e-2, 2 x floor)), logits scale "
        f"{float(full[..., :V].float().abs().max()):.2f}")
    log("rwkv", f"each wkv6 call of that run vs its plain version on the same inputs: {n} "
        f"calls, max abs err {e:.3e}, row err {r:.3e} (tolerance 2e-3, rows 1e-2)")
    log("rwkv", f"{L}-layer logits, kernel vs its plain version on the same path: forward max "
        f"abs err {err_full:.3e} (relative norm {rel_full:.3e}), prefill + decode steps "
        f"{err_step:.3e} ({rel_step:.3e}); plain version vs itself with w moved by 2^-20: "
        f"{floor:.3e} ({floor_rel:.3e}) (tolerance max(5e-2, 2 x that), both)")
    del full, full_ref, dec, dec_ref

    # Scoring at 2048 tokens.
    held.clear()
    seq = torch.randint(0, V, (1, 2048), generator=gen, device="cuda")
    with wkv6_swapped(wkv6_held(held, counted)):
        got, _ = tf.forward(model, cfg, {"tokens": seq})
    calls += 1
    with wkv6_swapped(plain):
        want, _ = tf.forward(model, cfg, {"tokens": seq})
    with wkv6_swapped(nudged):
        floor_long, floor_long_rel = logits_err(tf.forward(model, cfg, {"tokens": seq})[0],
                                                want, V)
    err_long, rel_long = logits_err(got, want, V)
    del got, want
    n, e, r = held["wkv6"]
    if not (err_long <= max(5e-2, 2 * floor_long)
            and rel_long <= max(5e-2, 2 * floor_long_rel)):
        raise AssertionError(f"2048-token logits differ from the plain version's: {err_long} "
                             f"({rel_long}), floor {floor_long} ({floor_long_rel})")
    log("rwkv", f"2048-token scoring: {n} wkv6 calls vs their plain version max abs err "
        f"{e:.3e}, row err {r:.3e}; logits vs the plain version's path max abs err "
        f"{err_long:.3e} (relative norm {rel_long:.3e}), floor {floor_long:.3e} "
        f"({floor_long_rel:.3e})")
    score = build_eval_step(cfg, StepConfig(logits_chunk=512))
    loss = float(score(model, {"tokens": seq}))
    calls += 1
    with wkv6_swapped(plain):
        ref = float(score(model, {"tokens": seq}))
    with wkv6_swapped(nudged):
        loss_floor = abs(float(score(model, {"tokens": seq})) - ref)
    if not (math.isfinite(loss) and abs(loss - ref) <= max(2e-2, 2 * loss_floor)):
        raise AssertionError(f"scoring loss {loss} vs plain {ref}, floor {loss_floor}")
    log("rwkv", f"2048-token scoring loss {loss:.5f}, plain version's path {ref:.5f} "
        f"(|diff| {abs(loss - ref):.2e}; with w moved by 2^-20 {loss_floor:.2e}; tolerance "
        f"max(2e-2, 2 x that))")

    launches = {"wkv6": wkv6.launches}
    main_path.close()
    if launches["wkv6"] != L * calls or sum(by_shape.values()) != launches["wkv6"]:
        raise AssertionError(f"rwkv launches {launches} ({by_shape} by (B, T)), want "
                             f"{L} x {calls} calls of S > 1")
    log("launches", f"rwkv path: wkv6 {launches['wkv6']} ({L} x {calls} decode_step and "
        "forward calls of S > 1 tokens, each launching the kernel pair); by (B, T): "
        + ", ".join(f"{b} x {t}: {n}" for (b, t), n in sorted(by_shape.items())))
    # The breakdown prefills 512 tokens (one call of S > 1), then decodes.
    serve_breakdown(server)
    if wkv6.launches != launches["wkv6"] + L:
        raise AssertionError(f"wkv6 launched at S = 1: {wkv6.launches - launches['wkv6']} "
                             f"launches for one prefill and 4 decode steps")
    log("launches", f"rwkv breakdown: {L} wkv6 launches for its 512-token prefill, none for "
        "its 4 decode steps")
    rwkv_cut(model, cfg, tokens)
    del model, server
    torch.cuda.empty_cache()
    wkv6_by_shape(by_shape)
    return launches


def graph_ms(fn, calls: int = 10) -> float:
    """Device time per call of ``fn()``: ``calls`` calls captured in one
    CUDA graph, its replay timed with CUDA events (no host time between
    launches)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = device_ms(graph.replay, iters=5, warmup=1) / calls
    del graph
    return ms


def wkv6_by_shape(by_shape: dict) -> None:
    """The kernel pair at each (B, T) of the main path's calls (bf16 r, k,
    v at rwkv6-3b's heads, a non-zero state, float32 out): the time per
    call back to back (CUDA events; at a few tokens it is the wrapper's
    host time) and on the device (calls replayed from a CUDA graph) beside
    the bound, and the launches times the device time's gap to the bound."""
    from repro_torch.kernels.rwkv6 import wkv6

    H, hs = RWKV["H"], RWKV["hs"]
    total = gap = 0.0
    for (B, T), n in sorted(by_shape.items()):
        r, k, v, w, u, S0 = wkv6_inputs(40 + B + T, B, T, H, hs, torch.bfloat16)
        call = lambda: wkv6(r, k, v, w, u, state=S0, out_dtype=torch.float32)
        ms, dev_ms = device_ms(call), graph_ms(call)
        bound = wkv6_bound(B, T, H, hs, 2)["bound_ms"]
        total, gap = total + n * dev_ms, gap + n * (dev_ms - bound)
        log("wkv6", f"main path at ({B}, {T}, {H}, {hs}): {n} launches; per call {ms:.4f} ms "
            f"back to back, {dev_ms:.4f} ms on the device, bound {bound:.4f} ms; "
            f"{n * dev_ms:.1f} ms on the device, {n * (dev_ms - bound):.1f} ms over the bound")
        del r, k, v, w, u, S0
    log("wkv6", f"main path: {sum(by_shape.values())} launches, {total:.1f} ms of device "
        f"time in the kernel pair, {gap:.1f} ms over the bound")


#: depth of the full-width cut of rwkv6-3b held against forward and the
#: plain path
RWKV_CUT = 4


def rwkv_cut(model, cfg, tokens) -> None:
    """The first RWKV_CUT layers of the full-width model (same weights) on
    the 160 tokens of phase_rwkv: prefill of 128 + 32 decode steps (float32
    state) against forward, and the kernel path against the plain version's
    path, elementwise.  In bf16 a 2^-20 change of w already moves these
    logits by about 0.2 (bf16 roundings flip), so the bf16 cut is held to
    its measured floor as the 32-layer path is; the same cut upcast to
    float32 has no such floor and is held to 2e-2 (tests/test_models_smoke.py)
    and 5e-2.  Its wkv6 launches (RWKV_CUT per call of S > 1) are checked
    here, after the main path's counts were read."""
    import dataclasses

    from repro_torch.kernels.rwkv6 import wkv6, wkv6_chunked_ref
    from repro_torch.models import transformer as tf

    V, n = cfg.vocab_size, RWKV_CUT
    nudged = lambda r, k, v, w, u, **kw: wkv6_chunked_ref(r, k, v, w * (1 - 2**-20), u, **kw)
    weights = {name: t for name, t in model.state_dict().items()
               if not name.startswith("blocks.") or int(name.split(".")[1]) < n}
    for dtype in ("bfloat16", "float32"):
        cut = dataclasses.replace(cfg, n_layers=n, param_dtype=dtype, compute_dtype=dtype)
        small = tf.Transformer(cut, device=tokens.device)
        small.load_state_dict(weights)
        held: dict = {}
        before = wkv6.launches
        with wkv6_swapped(wkv6_held(held)):
            full, _ = tf.forward(small, cut, {"tokens": tokens})
            dec = teacher_forced(small, cut, tokens, 128)
        if wkv6.launches - before != 2 * n:
            raise AssertionError(f"{n}-layer cut: {wkv6.launches - before} wkv6 launches for a "
                                 f"forward and a prefill, want {2 * n}")
        with wkv6_swapped(wkv6_chunked_ref):
            full_ref, _ = tf.forward(small, cut, {"tokens": tokens})
            dec_ref = teacher_forced(small, cut, tokens, 128)
        with wkv6_swapped(nudged):
            floor, floor_rel = logits_err(tf.forward(small, cut, {"tokens": tokens})[0],
                                          full_ref, V)
        err_dec, rel_dec = logits_err(dec, full[:, 127:], V)
        err_full, rel_full = logits_err(full, full_ref, V)
        err_step, rel_step = logits_err(dec, dec_ref, V)
        tol_dec, tol_path = (2e-2, 5e-2) if dtype == "float32" else (
            max(2e-2, 2 * floor), max(5e-2, 2 * floor))
        log("rwkv", f"{n}-layer cut at full width in {dtype}, 160 tokens: prefill 128 + 32 "
            f"decode steps (f32 state) vs forward max abs err {err_dec:.3e} (relative norm "
            f"{rel_dec:.3e}; tolerance {tol_dec:.3g}); kernel vs plain path: forward "
            f"{err_full:.3e} ({rel_full:.3e}), prefill + decode {err_step:.3e} ({rel_step:.3e}) "
            f"(tolerance {tol_path:.3g}); plain path vs itself with w moved by 2^-20: "
            f"{floor:.3e} ({floor_rel:.3e}); logits scale "
            f"{float(full[..., :V].float().abs().max()):.2f}; {held['wkv6'][0]} wkv6 calls "
            f"held, max abs err {held['wkv6'][1]:.3e}")
        if not err_dec <= tol_dec:
            raise AssertionError(f"{n}-layer {dtype} cut: decode_step differs from forward by "
                                 f"{err_dec}")
        if not (err_full <= tol_path and err_step <= tol_path):
            raise AssertionError(f"{n}-layer {dtype} cut: kernel-path logits differ from the "
                                 f"plain version's: forward {err_full}, decode_step {err_step}")
        del small, full, full_ref, dec, dec_ref
        torch.cuda.empty_cache()


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
    report.update(phase_attention())

    t0 = time.perf_counter()
    apps = {name: make_app(name, TOKENS) for name in ("wordcount", "eximparse")}
    expect, pairs = {}, {}  # numpy's count of the corpus, and the pairs the map emits
    for M, _, _ in ENGINE_CONFIGS:
        counts = np.bincount(apps["wordcount"][1])
        expect[("wordcount", M)] = {int(k): int(counts[k]) for k in np.flatnonzero(counts)}
        pairs[("wordcount", M)] = TOKENS
        expect[("eximparse", M)], pairs[("eximparse", M)] = exim_expected(
            apps["eximparse"][1], M)
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

    # The traced and pipelined modes, the all-to-all shuffle and the
    # resumable jobs, each path counted from zero.
    traces = {}
    for path, drive in (("traced", lambda: phase_traced(apps, expect, pairs, traces)),
                        ("pipelined", lambda: phase_pipelined(apps)),
                        ("a2a", lambda: phase_a2a(apps, expect)),
                        ("elastic", lambda: phase_elastic(apps)),
                        ("estimator", lambda: phase_estimator(apps, traces)),
                        ("cluster", phase_cluster)):
        segment_reduce.launches = 0
        local_reduce.launches = 0
        t_path = time.perf_counter()
        want = drive()
        made = {"segment_reduce": segment_reduce.launches,
                "local_reduce": local_reduce.launches}
        if made != want:
            raise AssertionError(f"{path} path launches {made}, want {want}")
        log("launches", f"{path} path: segment_reduce {made['segment_reduce']}, local_reduce "
            f"{made['local_reduce']} (as its jobs' reduce waves, groups, slots or steps and "
            f"combiners), {time.perf_counter() - t_path:.1f} s")
        for name, n in made.items():
            launches[name] += n
    del apps
    torch.cuda.empty_cache()

    # The serving paths, qwen3-0.6b then gemma-7b (head_dim 256), each
    # counted from zero inside.
    launches.update(phase_serve())
    torch.cuda.empty_cache()
    gemma = phase_serve("gemma-7b", tag="gemma", requests=8, long_new=32)
    for name, n in gemma.items():
        launches[name] += n
    torch.cuda.empty_cache()

    # The rwkv6-3b path: the WKV6 kernel alone, then serving and scoring,
    # counted from zero inside.
    report.update(phase_wkv6())
    launches.update(phase_rwkv())

    sources = {"segment_reduce": ("src/repro_torch/csrc/segment_reduce.cu",
                                  "src/repro/kernels/segment_reduce/kernel.py:28"),
               "local_reduce": ("src/repro_torch/csrc/local_reduce.cu",
                                "src/repro/kernels/local_reduce/kernel.py:36"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention/kernel.py:31"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention/kernel.py:31"),
               "wkv6": ("src/repro_torch/csrc/wkv6.cu", "src/repro/kernels/rwkv6/kernel.py:30")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": report[name]["max_abs_err"],
         "ms": report[name]["ms"], "plain_ms": report[name]["plain_ms"],
         "bound_ms": report[name]["bound_ms"],
         "bound_by": report[name].get("bound_by", "bytes"),
         "library_ms": report[name].get("library_ms"), "shape": report[name]["shape"]}
        for name, (src, replaces) in sources.items()]}
    if any(k["launches"] < 1 for k in line["kernels"]):
        raise AssertionError(f"a kernel was not launched on its main path: {launches}")
    print(json.dumps(line))
    print(f"card: {card_line()}")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
