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
   the card at the qwen3-0.6b serving shapes, gemma-7b's head_dim 256
   shapes (decode over a ragged kv_len split into 64-key tiles, the
   long-prompt prefill, flash causal and non-causal with Sk > Sq),
   granite's head_dim 64 shapes, internvl2-26b's G = 6 shapes (prefill,
   decode, scoring) and hubert-xlarge's non-causal head_dim 80 encode, bfloat16
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
   span trace); then the engine-sharded arm: ``EngineOracle(sharded=True,
   traced=True)`` on one NCCL rank in a process of its own on card 0, 4
   jobs of 2**22-2**24 tokens under fifo-static on ``cuda`` and
   predict-sjf (backends ``torch`` and ``cuda``, worker grid (1,)), every
   job complete with map, shuffle and reduce walls above 0, a grant of 2
   refused naming the one visible card.  Every job completes or is
   rejected, fifo-static completes all, every trace conserves with its
   configuration's phases, and the ``segment_reduce`` / ``local_reduce``
   launches (the rank process's included) equal what the oracles'
   ``cuda`` runs must make (one a reduce wave or step, one a combiner
   job, warmups included); per policy the makespan, mean
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
   token, and one decode step's device time by kernel;
17. train: the training path of qwen3-0.6b at full width through
   ``launch/train.py``'s ``run_training``: 50 steps at 8 x 512 with
   checkpoints every 10 and a failure injected at step 25 (restored from
   step 20 and replayed), the mean of the last 5 losses below the first 5,
   save and restore walls of the 6 GB train state; 3 steps replayed twice
   from one seed, equal; the gradient of a float32 cut (first 4 layers at
   full width) against central differences per parameter group, and the
   same check rejecting a gradient with one layer's attention zeroed;
   ms/step at 16 x 512 over microbatch 1, 2, 8, 16, the paper's degree-2
   fit and its prediction at the held-out microbatch 4 against a
   measurement; the trained weights scored through ``flash_attention``
   and through the plain path within 2e-2, with exactly one launch a
   layer; step ms, tokens/s and peak memory beside the card.  The train
   steps take the plain routes (the kernels have no backward, as the
   reference's Pallas kernels have no gradient).  The serving phases run
   under ``torch.no_grad``;
18. granite (served after phase 14, trained after phase 17):
   granite-moe-1b-a400m (24 layers, 32 experts top-8 on every layer,
   heads of 64) through phase 13's serving steps with 8 requests
   and 8 prompts of 2048 tokens into a 4096-slot cache, 32 new tokens; its
   comparisons of decode with forward at a capacity factor of E / K, where
   nothing drops (capacity depends on the tokens of the call); dropping
   at the production factor held on the first MoE layer's real input
   (kept slots equal to the k-major cumsum construction, min(load,
   capacity) an expert, undropped tokens equal to the no-drop output);
   phase 3 holds both kernels at its head_dim 64 shapes; after ``train``,
   10 train steps at 8 x 512 through ``run_training`` (the loss with the
   aux), each step's aux positive and finite; a 2-layer float32 cut's loss
   equal to its cross-entropy plus the weighted aux, and its gradient
   against central differences (the routing held at theta's) for each
   router, one expert, an attention layer and the embedding, with a
   zeroed router gradient rejected;
19. jamba (after granite's serving): one 8-layer period of jamba-v0.1-52b
   at full width (7 Mamba layers of d_in 8192, one attention layer, MoE of
   16 experts top-2 on the odd positions; 32 layers do not fit the card):
   the serving steps,
   8 prompts of 2048 tokens into a 4096-slot cache with 32 new tokens,
   the bf16 forward against the attention's plain versions' path within
   twice its floor, prefill 16 + 8 decode steps against the forward pass
   held in float32 (in bf16 top-2 routing flips at near-ties, so there it
   is printed), each attention call held against its plain version and
   each Mamba decode step (one recurrence step) against the plain chunked
   scan of the same inputs padded to a 256-step chunk, one attention
   launch a call;
20. internvl (after jamba): internvl2-26b at full width and depth (48
   layers, 48 / 8 heads of 128, so G = 6; 39.8 GB of bf16 weights)
   through the step builders: 8 prompts of 256 patch embeddings and 2048
   text tokens into a 4096-slot cache, 32 greedy new tokens with an empty
   patch prefix; phase 13's kernel-path checks on 256 patches + 24
   tokens (its float32 upcast on the first 4 layers) and text-only
   scoring of 256 + 2048 positions; phase 3 holds both kernels at its
   G = 6 shapes;
21. hubert (after granite's training): hubert-xlarge at full width and
   depth (48 layers, 16 heads of 80, non-causal): 8 x 2048 frames encoded
   through the encoder's prefill step, each ``flash_attention`` call held
   against its plain version, the logits against the plain versions'
   path and the plain path, the per-frame loss with about 10 % of labels
   at -100, kernels against plain; 10 train steps at 8 x 512 on the plain
   routes, the loss falling on labels that are a fixed function of the
   frames; a 2-layer float32 cut's gradient per group against central
   differences, a zeroed attention gradient rejected; phase 3 holds
   ``flash_attention`` at its head_dim 80 shape;
22. sharding (after hubert): qwen3-0.6b at full width laid out by
   ``sharding.rules.param_specs(fsdp=True)`` as DTensors on a (1, 1)
   ("data", "model") mesh over an NCCL world of one rank, its caches by
   ``decode_state_specs``: 8 prompts of 2048 into 4096 slots through
   ``decode_attention``, 8 decode steps and 2048-token scoring through
   ``flash_attention`` (each twice, the second timed; the kernels run on
   the local shards, one launch a layer a call) held against the same
   weights without a mesh (relative norm 5e-2; bit-equal expected on one
   rank), and a 4-layer float32 cut at 2e-5; ``run_training(mesh=...)``
   for 5 steps at 8 x 512 against the unsharded trainer's losses (1e-6
   relative); the unsharded trainer's checkpoint restored onto the mesh
   and saved back bit-equal leaf by leaf; two compressed DP steps, mesh
   form against ``group=`` form, bit-equal; walls and peak beside the
   unsharded ones; then two dry runs started at the phase's start on the
   host (fake process groups, no device): qwen3-0.6b ``train_4k`` on the
   16 x 16 production mesh at 256 fake ranks, its three roofline terms,
   dominant term and peak, and the (1, 1) cell at phase 17's shape and
   ``StepConfig`` beside the step measured here (information only);
23. examples: the port's examples in-process at their smallest flags
   (``mapreduce_wordcount`` plain and with ``--combiner --phase-times``,
   ``phase_breakdown``, ``cluster_sim --real``, ``elastic_preempt``,
   ``serve_lm``), each checking its own result, with its wall and its
   launches; ``segment_reduce``, ``local_reduce``, ``decode_attention``
   and ``flash_attention`` must each launch.

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
#: the engine-sharded arm: SHARDED_JOBS jobs over SHARDED_SIZES on one
#: rank process (NCCL, card 0); predict-sjf bootstraps on SHARDED_GRIDS at
#: the same sizes (24 configurations: its cubic fit needs 19)
SHARDED_JOBS, SHARDED_SIZES = 4, (1 << 22, 1 << 24)
SHARDED_GRIDS = dict(mapper_grid=(8, 16, 24, 32), reducer_grid=(4, 8, 16), worker_grid=(1,))
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


def sharded_arm(want: dict) -> dict:
    """The engine-sharded arm of the cluster phase: ``EngineOracle(sharded=True,
    traced=True)``, whose grant of one worker is one rank process of its own
    (NCCL on card 0), schedules SHARDED_JOBS jobs under fifo-static on
    ``cuda`` and predict-sjf (backends torch and cuda, worker grid (1,)).
    Every job completes, every trace has map, shuffle and reduce walls above
    0 and conserves; a grant of 2 raises naming the one visible card.  Adds
    the launches the rank's ``cuda`` runs must make to ``want`` (R
    segment_reduce a run at W = 1, warmups included) and returns the
    launches the rank process counted."""
    from repro_torch.cluster import Cluster, EngineOracle, generate_workload, get_policy

    jobs = generate_workload(SHARDED_JOBS, seed=8, mean_interarrival=0.05,
                             size_range=SHARDED_SIZES)
    with EngineOracle(sharded=True, traced=True, size_quantum=1 << 20, device="cuda") as oracle:
        time_, seen = oracle.time, set()

        def timed(app, backend, size, M, R, W, job_id=0, depth=1, combiner=False):
            t = time_(app, backend, size, M, R, W, job_id=job_id, depth=depth, combiner=combiner)
            key = (app, oracle._snap(size), backend, M, R, W, combiner)
            runs = 1 + oracle.warmup * (key not in seen)
            seen.add(key)
            if backend == "cuda":
                want["segment_reduce"] += runs * math.ceil(R / W)
                want["local_reduce"] += runs * int(combiner)
            return t

        oracle.time = timed
        for name, kw in (("fifo-static", {"backend": "cuda", "mappers": 20, "reducers": 5,
                                          "workers": 1}),
                         ("predict-sjf", {"backends": ("torch", "cuda"), "seed": 0,
                                          "bootstrap_sizes": SHARDED_SIZES, **SHARDED_GRIDS})):
            t0 = time.perf_counter()
            result = Cluster(1, oracle).run(jobs, get_policy(name, **kw))
            wall = time.perf_counter() - t0
            check_records(f"engine-sharded {name}", result, len(jobs))
            if result.metrics()["n_completed"] != len(jobs):
                raise AssertionError(f"engine-sharded {name} left jobs: {result.metrics()}")
            for r in result.records:
                times = r.trace.phase_times()
                if min(times[p] for p in ("map", "shuffle", "reduce")) <= 0:
                    raise AssertionError(f"engine-sharded {name} job {r.spec.job_id}: {times}")
            log("cluster", policy_line(f"engine-sharded {name}", result, wall)
                + "; phase walls (ms) " + "; ".join(
                    "/".join(f"{r.trace.phase_times()[p] * 1e3:.2f}"
                             for p in ("map", "shuffle", "reduce"))
                    for r in result.records))
        try:
            oracle.time("wordcount", "cuda", SHARDED_SIZES[0], 20, 5, 2)
        except ValueError as e:
            if "needs 2 devices but only 1 " not in str(e):
                raise
            log("cluster", f"engine-sharded grant 2 refused: {e}")
        else:
            raise AssertionError("engine-sharded grant 2 ran on one card")
        made = dict(oracle.rank_launches)
    log("cluster", f"engine-sharded rank launches {made} (wanted {want} so far in the phase)")
    return made


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
    Then the engine-sharded arm (``sharded_arm``).  Returns the launches
    the oracles' cuda runs must have made, and those the rank process
    made."""
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
    ranks = sharded_arm(want)
    log("cluster", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches wanted {want}")
    if min(want.values()) < 1 or ranks["segment_reduce"] < 1:
        raise AssertionError(f"the cluster path planned no cuda work: {want}, ranks {ranks}")
    return want, ranks


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
#: per (query, head) row: the norm of the difference over the norm of the
#: plain version's row.  A row that averages thousands of keys is small
#: (|out| about 0.01 at 32k keys), so the elementwise 5e-2 alone would pass
#: an all-zero output; this holds each row to its own scale.
ATTN_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
QWEN = dict(Hq=16, n_kv=8, hd=128)  # qwen3-0.6b attention geometry
GEMMA = dict(Hq=16, n_kv=16, hd=256)  # gemma-7b's: MHA, head_dim 256
GRANITE = dict(Hq=16, n_kv=8, hd=64)  # granite-moe-1b-a400m's: head_dim 64
INTERNVL = dict(Hq=48, n_kv=8, hd=128)  # internvl2-26b's: G = 6
HUBERT = dict(Hq=16, n_kv=16, hd=80)  # hubert-xlarge's: head_dim 80, non-causal


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
        keep = torch.cat([torch.arange(a), torch.arange(min(a + keys, n_visible), n_visible)])
        keep = keep.to(k.device)
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
    # granite-moe-1b-a400m's heads (16 / 8 of 64, the kernels' hd <= 64
    # instances): its decode over a 4096-slot cache, its long-prompt
    # prefill and its 2048-token scoring.
    rH, rkv, rhd = GRANITE["Hq"], GRANITE["n_kv"], GRANITE["hd"]
    cases += [
        ("decode_attention", f"granite decode B=8 Sq=1 kv_len=S_max={P_max}",
         ((8, 1, rH, rhd), (8, P_max, rkv, rhd)), P_max,
         lambda q, k, v: decode_attention(q, k, v, P_max),
         lambda q, k, v: decode_attention_ref(q, k, v, P_max),
         lambda q, k, v: F.scaled_dot_product_attention(
             q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), enable_gqa=True),
         attention_bound(8, 1, rH, rkv, rhd, P_max, P_max)),
        ("decode_attention", f"granite prefill B=8 Sq=kv_len={S_pre} S_max={P_max}",
         ((8, S_pre, rH, rhd), (8, P_max, rkv, rhd)), S_pre,
         lambda q, k, v: decode_attention(q, k, v, S_pre),
         lambda q, k, v: decode_attention_ref(q, k, v, S_pre),
         lambda q, k, v: F.scaled_dot_product_attention(
             q.transpose(1, 2), k[:, :S_pre].transpose(1, 2), v[:, :S_pre].transpose(1, 2),
             is_causal=True, enable_gqa=True),
         attention_bound(8, S_pre, rH, rkv, rhd, S_pre, S_pre * (S_pre + 1) // 2)),
        ("flash_attention", f"granite causal B=1 S={S_pre}",
         ((1, S_pre, rH, rhd), (1, S_pre, rkv, rhd)), S_pre,
         lambda q, k, v: flash_attention(q, k, v, causal=True),
         lambda q, k, v: flash_attention_ref(q, k, v, causal=True),
         lambda q, k, v: F.scaled_dot_product_attention(
             q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
             enable_gqa=True),
         attention_bound(1, S_pre, rH, rkv, rhd, S_pre, S_pre * (S_pre + 1) // 2)),
    ]
    # internvl2-26b's heads (48 / 8 of 128, so G = 6 query heads a KV head):
    # its scoring of 256 patches + 2048 tokens, its prefill of 8 such
    # prompts into a 4096-slot cache and a decode step past them; and
    # hubert-xlarge's (16 of 80, the hd <= 128 instance with zeros past
    # 80): its non-causal encode of 8 x 2048 frames.
    vH, vkv, vhd = INTERNVL["Hq"], INTERNVL["n_kv"], INTERNVL["hd"]
    hH, hkv, hhd = HUBERT["Hq"], HUBERT["n_kv"], HUBERT["hd"]
    S_vl, kv_vl = 256 + S_pre, 256 + S_pre + 26
    cases += [
        ("flash_attention", f"hubert non-causal B=8 S={S_pre} hd=80",
         ((8, S_pre, hH, hhd), (8, S_pre, hkv, hhd)), S_pre,
         lambda q, k, v: flash_attention(q, k, v, causal=False),
         lambda q, k, v: flash_attention_ref(q, k, v, causal=False),
         lambda q, k, v: F.scaled_dot_product_attention(
             q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), enable_gqa=True),
         attention_bound(8, S_pre, hH, hkv, hhd, S_pre, S_pre * S_pre)),
        ("flash_attention", f"internvl causal B=1 S={S_vl} G=6",
         ((1, S_vl, vH, vhd), (1, S_vl, vkv, vhd)), S_vl,
         lambda q, k, v: flash_attention(q, k, v, causal=True),
         lambda q, k, v: flash_attention_ref(q, k, v, causal=True),
         lambda q, k, v: F.scaled_dot_product_attention(
             q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
             enable_gqa=True),
         attention_bound(1, S_vl, vH, vkv, vhd, S_vl, S_vl * (S_vl + 1) // 2)),
        ("decode_attention", f"internvl prefill B=8 Sq=kv_len={S_vl} S_max={P_max} G=6",
         ((8, S_vl, vH, vhd), (8, P_max, vkv, vhd)), S_vl,
         lambda q, k, v: decode_attention(q, k, v, S_vl),
         # the slots past kv_len are invisible: the plain version reads
         # only the first S_vl (its float32 scores are then 8 GB, not 14)
         lambda q, k, v: decode_attention_ref(q, k[:, :S_vl], v[:, :S_vl], S_vl),
         lambda q, k, v: F.scaled_dot_product_attention(
             q.transpose(1, 2), k[:, :S_vl].transpose(1, 2), v[:, :S_vl].transpose(1, 2),
             is_causal=True, enable_gqa=True),
         attention_bound(8, S_vl, vH, vkv, vhd, S_vl, S_vl * (S_vl + 1) // 2)),
        ("decode_attention", f"internvl decode B=8 Sq=1 kv_len={kv_vl} S_max={P_max} G=6",
         ((8, 1, vH, vhd), (8, P_max, vkv, vhd)), kv_vl,
         lambda q, k, v: decode_attention(q, k, v, kv_vl),
         lambda q, k, v: decode_attention_ref(q, k, v, kv_vl),
         lambda q, k, v: F.scaled_dot_product_attention(
             q.transpose(1, 2), k[:, :kv_vl].transpose(1, 2), v[:, :kv_vl].transpose(1, 2),
             enable_gqa=True),
         attention_bound(8, 1, vH, vkv, vhd, kv_vl, kv_vl)),
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


def lm_batch(tokens, patches=None) -> dict:
    """A model batch of ``tokens``, after ``patches`` for a VLM."""
    return {"tokens": tokens} if patches is None else {"tokens": tokens, "patches": patches}


def teacher_forced(model, cfg, tokens, n_prompt: int, patches=None):
    """Kernel-path logits at text positions n_prompt - 1 .. S - 1: a prefill
    of n_prompt tokens (after ``patches`` for a VLM) through decode_step,
    then one decode step per token (a VLM's with an empty patch prefix),
    with a float32 cache.  Makes 1 + S - n_prompt decode_step calls."""
    from repro_torch.models import transformer as tf

    B, S = tokens.shape
    P = 0 if patches is None else patches.shape[1]
    empty = None if patches is None else patches[:, :0]
    state = tf.init_decode_state(cfg, B, P + S, cache_dtype=torch.float32,
                                 device=tokens.device)
    logits, state = tf.decode_step(model, cfg, state, lm_batch(tokens[:, :n_prompt], patches),
                                   use_flash=True)
    out = [logits[:, -1]]
    for i in range(n_prompt, S):
        logits, state = tf.decode_step(model, cfg, state, lm_batch(tokens[:, i:i + 1], empty),
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

    cfg = get_config(arch)
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

    if cfg.moe is not None:
        moe_drops(model, cfg, tag)
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen, device="cuda")
    checks = check_kernel_path(model, cfg, tag, tokens)
    seq = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    forwards += check_scoring(model, cfg, tag, {"tokens": seq})
    launches = path_launches(tag, cfg, steps, forwards, checks)
    serve_breakdown(server)
    return launches


def path_launches(tag: str, cfg, steps: int, forwards: int, checks: dict) -> dict:
    """The attention launches counted since the path's start, held against
    one a layer for each of its ``steps`` decode_step and ``forwards``
    forward calls plus the ``checks`` launches of ``check_kernel_path``."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    L = cfg.n_layers
    launches = {"decode_attention": decode_attention.launches,
                "flash_attention": flash_attention.launches}
    want = {"decode_attention": L * steps + checks["decode_attention"],
            "flash_attention": L * forwards + checks["flash_attention"]}
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, want {want} ({L} per call: {steps} "
                             f"decode_step, {forwards} forward calls; {checks} in the "
                             f"kernel-path checks)")
    log("launches", f"{tag} path ({cfg.name}): decode_attention "
        f"{launches['decode_attention']} ({L} x {steps} decode_step calls + "
        f"{checks['decode_attention']} in the kernel-path checks), flash_attention "
        f"{launches['flash_attention']} ({L} x {forwards} forward calls + "
        f"{checks['flash_attention']})")
    return launches


def check_kernel_path(model, cfg, tag: str, tokens, patches=None,
                      f32_layers: int | None = None) -> dict:
    """The kernel path on a prompt of 24 tokens (after ``patches`` for a
    VLM); returns the attention launches it made (one forward and 9
    decode_step calls at full depth and on the float32 cut).

    Forward, and prefill + decode steps through decode_step, every kernel
    call held against its plain version on the same inputs.  An MoE
    model's capacity depends on the tokens of the call, so there decode
    and forward drop different slots at the production capacity factor:
    these comparisons run at E / K, where nothing drops (``moe_drops``
    holds the dropping).  Then the full-depth logits against the same path
    with the plain versions (float32 scores and p, as the kernels); against
    the plain versions with the softmax scale moved by 2^-20, the floor to
    which the bf16 model amplifies any sub-ulp difference; and against the
    plain path (use_flash=False: _sdpa rounds the scores and p to bf16);
    then ``float32_path`` on the first ``f32_layers`` layers (all by
    default).
    """
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models import transformer as tf

    plain_versions = (decode_attention_ref, flash_attention_ref)
    nudged = (decode_attention_ref, functools.partial(
        flash_attention_ref, sm_scale=(1 + 2**-20) * cfg.resolved_head_dim**-0.5))

    V = cfg.vocab_size
    P = 0 if patches is None else patches.shape[1]
    batch = lm_batch(tokens, patches)
    held: dict = {}
    ccfg = no_drop(cfg)
    with attention_swapped(*held_against_plain(held)):
        full, _ = tf.forward(model, ccfg, batch, use_flash=True)
        dec = teacher_forced(model, ccfg, tokens, 16, patches)
    with attention_swapped(*plain_versions):
        full_ref, _ = tf.forward(model, ccfg, batch, use_flash=True)
        dec_ref = teacher_forced(model, ccfg, tokens, 16, patches)
    with attention_swapped(*nudged):
        floor, floor_rel = logits_err(
            tf.forward(model, ccfg, batch, use_flash=True)[0], full_ref, V)
    plain, _ = tf.forward(model, ccfg, batch, use_flash=False)
    # Decode vs forward: 2e-2 (tests/test_models_smoke.py), or twice what
    # the same model gives with the kernels' plain versions where the rest
    # of the bf16 model already differs more (gemma-7b: cuBLAS takes other
    # GEMMs at 2 rows than at 48, and 28 layers amplify the roundings); the
    # float32 upcast below is held to 2e-2 without that floor.
    err_dec, _ = logits_err(dec, full[:, P + 15:], V)
    floor_dec, _ = logits_err(dec_ref, full_ref[:, P + 15:], V)
    tol_dec = max(2e-2, 2 * floor_dec)
    if not torch.allclose(dec[..., :V].float(), full[:, P + 15:, :V].float(), rtol=2e-2,
                          atol=tol_dec):
        raise AssertionError(f"decode_step differs from forward: max abs err {err_dec}, "
                             f"{floor_dec} with the plain versions")
    err_full, rel_full = logits_err(full, full_ref, V)
    err_step, _ = logits_err(dec, dec_ref, V)
    # An MoE model's routing turns a sub-ulp change into another expert at
    # near-ties, so there (and only there) the relative norms too are held
    # to twice the floor's, and to twice the plain versions' own distance
    # from the plain path; a dense model's stay at 5e-2.
    moe = cfg.moe is not None
    limit = max(5e-2, 2 * floor)
    rel_limit = max(5e-2, 2 * floor_rel) if moe else 5e-2
    if not (err_full <= limit and err_step <= limit and rel_full <= rel_limit):
        raise AssertionError(f"kernel-path logits differ from the kernels' plain versions: "
                             f"forward {err_full} (relative norm {rel_full}), decode_step "
                             f"{err_step}, floor {floor} (relative norm {floor_rel})")
    err_plain, rel_plain = logits_err(full, plain, V)
    err_ref_plain, rel_ref_plain = logits_err(full_ref, plain, V)
    plain_limit = max(rel_limit, 2 * rel_ref_plain) if moe else 5e-2
    if not rel_plain <= plain_limit:
        raise AssertionError(f"kernel-path logits differ from the plain path: relative norm "
                             f"{rel_plain}, the plain versions' {rel_ref_plain}")
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
        f"softmax scale moved by 2^-20: {floor:.3e} (relative norm {floor_rel:.3e}; "
        f"tolerance {limit:.3g}, relative norm {rel_limit:.3g})")
    log(tag, f"{cfg.n_layers}-layer forward logits vs the plain path (_sdpa): kernels "
        f"max abs err {err_plain:.3e}, relative norm {rel_plain:.3e} (tolerance "
        f"{plain_limit:.3g}); "
        f"the kernels' plain versions max abs err {err_ref_plain:.3e}, relative norm "
        f"{rel_ref_plain:.3e}")
    del full, full_ref, dec, dec_ref, plain
    float32_path(model, ccfg, tokens, tag, plain_versions, patches, f32_layers)
    layers = cfg.n_layers + (f32_layers or cfg.n_layers)
    return {"decode_attention": 9 * layers, "flash_attention": layers}


def check_scoring(model, cfg, tag: str, batch: dict) -> int:
    """Scoring one long sequence: every kernel call held against its plain
    version, the logits against the plain versions' path (with its floor),
    the eval loss against the plain path, then its time; returns the
    forward calls of the kernel path it made."""
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models import transformer as tf
    from repro_torch.train import StepConfig, build_eval_step

    V = cfg.vocab_size
    S = tf.input_shape(cfg, batch)[1]
    plain_versions = (decode_attention_ref, flash_attention_ref)
    nudged = (decode_attention_ref, functools.partial(
        flash_attention_ref, sm_scale=(1 + 2**-20) * cfg.resolved_head_dim**-0.5))
    moe = cfg.moe is not None
    held: dict = {}
    forwards = 0
    with attention_swapped(*held_against_plain(held)):
        got, _ = tf.forward(model, cfg, batch, use_flash=True)
    forwards += 1
    with attention_swapped(*plain_versions):
        want, _ = tf.forward(model, cfg, batch, use_flash=True)
    with attention_swapped(*nudged):
        floor_long, floor_long_rel = logits_err(
            tf.forward(model, cfg, batch, use_flash=True)[0], want, V)
    err_long, rel_long = logits_err(got, want, V)
    del got, want
    n, e, r = held["flash_attention"]
    rel_long_limit = max(5e-2, 2 * floor_long_rel) if moe else 5e-2
    if not (err_long <= max(5e-2, 2 * floor_long) and rel_long <= rel_long_limit):
        raise AssertionError(f"{S}-token logits differ from the kernels' plain versions: "
                             f"{err_long} (relative norm {rel_long}), floor {floor_long} "
                             f"(relative norm {floor_long_rel})")
    log(tag, f"{S}-token scoring: {n} flash_attention calls vs their plain versions "
        f"max abs err {e:.3e}, row err {r:.3e}; logits vs the plain versions' path max abs "
        f"err {err_long:.3e} (relative norm {rel_long:.3e}, tolerance {rel_long_limit:.3g}), "
        f"floor {floor_long:.3e} (relative norm {floor_long_rel:.3e})")
    loss = float(build_eval_step(cfg, StepConfig(use_flash=True, logits_chunk=512))(
        model, batch))
    forwards += 1
    ref = float(build_eval_step(cfg, StepConfig(logits_chunk=512))(model, batch))
    if not (math.isfinite(loss) and abs(loss - ref) <= 2e-2):
        raise AssertionError(f"scoring loss {loss} vs plain {ref}")
    log(tag, f"{S}-token scoring loss {loss:.5f}, plain path {ref:.5f} "
        f"(|diff| {abs(loss - ref):.2e}, tolerance 2e-2)")
    score = build_eval_step(cfg, StepConfig(use_flash=True, logits_chunk=512))
    walls = []
    for _ in range(4):  # a warm-up, then three timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score(model, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    forwards += 4
    log(tag, f"{S}-token scoring time (eval step, kernel path, fenced): "
        f"{', '.join(f'{w * 1e3:.2f}' for w in walls[1:])} ms")
    return forwards


def float32_path(model, cfg, tokens, tag: str, plain_versions, patches=None,
                 n_layers: int | None = None) -> None:
    """The model (its first ``n_layers`` layers; all by default) with the
    same weights upcast to float32, where no bf16 rounding is amplified: a
    forward and a prefill of 16 + 8 decode steps on the kernel path (each
    attention call held against its plain version at the float32
    tolerance), decode vs forward to 2e-2 (tests/test_models_smoke.py) and
    the kernel path against the plain versions' path to 5e-2.  Makes 9
    decode_step and 1 forward call of the kernel path."""
    import dataclasses

    from repro_torch.models import transformer as tf

    V = cfg.vocab_size
    P = 0 if patches is None else patches.shape[1]
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                                n_layers=n_layers or cfg.n_layers)
    model32 = tf.Transformer(cfg32, device=tokens.device)
    keys = set(model32.state_dict())
    model32.load_state_dict({k: w for k, w in model.state_dict().items() if k in keys})
    batch = lm_batch(tokens, patches)
    held: dict = {}
    with attention_swapped(*held_against_plain(held)):
        full, _ = tf.forward(model32, cfg32, batch, use_flash=True)
        dec = teacher_forced(model32, cfg32, tokens, 16, patches)
    with attention_swapped(*plain_versions):
        full_ref, _ = tf.forward(model32, cfg32, batch, use_flash=True)
        dec_ref = teacher_forced(model32, cfg32, tokens, 16, patches)
    err_dec, rel_dec = logits_err(dec, full[:, P + 15:], V)
    err_full, rel_full = logits_err(full, full_ref, V)
    err_step, _ = logits_err(dec, dec_ref, V)
    log(tag, f"{cfg32.n_layers} layers upcast to float32: prefill 16 + 8 decode steps vs "
        f"forward max abs err {err_dec:.3e} (relative norm {rel_dec:.3e}; tolerance 2e-2); "
        f"kernel vs plain versions' path: forward {err_full:.3e} (relative norm "
        f"{rel_full:.3e}), decode steps {err_step:.3e} (tolerance 5e-2); " + "; ".join(
            f"{name} {n} calls held, max abs err {e:.3e}, row err {r:.3e}"
            for name, (n, e, r) in sorted(held.items())) + " (tolerance 2e-5, rows 1e-4)")
    if not torch.allclose(dec[..., :V], full[:, P + 15:, :V], rtol=2e-2, atol=2e-2):
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


#: the [train] phase: qwen3-0.6b at full width through launch/train.py
TRAIN = dict(batch=8, seq=512, steps=50, lr=1e-3, ckpt_every=10, fail_at=25)
#: the step-time profile over the microbatch knob, and the held-out knob
PROFILE_BATCH, PROFILE_SEQ, PROFILE_KNOBS, HELD_OUT_KNOB = 16, 512, (1, 2, 8, 16), 4
#: depth of the float32 cut whose gradient is held against central differences
TRAIN_CUT = 4
#: directional-derivative check: relative step of each parameter, tolerance
GRAD_H, GRAD_RTOL, GRAD_ATOL = 1e-2, 2e-2, 1e-4


class TimedCheckpoints:
    """Wraps the trainer's ``CheckpointManager`` to time its saves (the
    blocking host copy of ``save_async``, the background write, the
    synchronous ``save``) and restores, and to count them."""

    def __init__(self):
        from repro_torch.checkpoint import CheckpointManager

        walls = self.walls = {"copy": [], "write": [], "save": [], "restore": []}

        def timed(name, fn):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                walls[name].append(time.perf_counter() - t0)
                return out
            return call

        class Timed(CheckpointManager):
            save_async = timed("copy", CheckpointManager.save_async)
            _write = timed("write", CheckpointManager._write)
            save = timed("save", CheckpointManager.save)
            restore = timed("restore", CheckpointManager.restore)

        self.cls = Timed


def grad_groups(names, n_layers: int) -> dict:
    """The parameter groups of the gradient check: each layer's attention,
    each layer's FFN with its norms, and the embedding with the final norm."""
    groups = {"embed + final_norm": ["embed", "final_norm"]}
    for l in range(n_layers):
        groups[f"attn {l}"] = [n for n in names if n.startswith(f"blocks.{l}.attn.")]
        groups[f"ffn {l}"] = [n for n in names if n.startswith(f"blocks.{l}.")
                              and not n.startswith(f"blocks.{l}.attn.")]
    return groups


def directional_check(loss_at, params: dict, grads: dict, groups: dict, seed: int) -> dict:
    """Per group G: the autograd directional derivative <g_G, d_G> against
    the central difference (L(theta + h d) - L(theta - h d)) / 2h, d_G
    Gaussian scaled by each parameter's rms (a relative step of about h),
    from a seeded generator, independent of the gradient under test.  A
    group lists its parameters, or maps each to an index of its leading
    axis (one expert's slice), outside which d is zero.
    Returns {group: (directional, central difference)}."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, names in groups.items():
        rows = names if isinstance(names, dict) else dict.fromkeys(names)
        d = {}
        for n, row in rows.items():
            d[n] = torch.randn(params[n].shape, generator=gen, device="cuda") \
                * params[n].detach().pow(2).mean().sqrt()
            if row is not None:
                d[n][torch.arange(len(d[n]), device="cuda") != row] = 0
        saved = {n: params[n].detach().clone() for n in rows}
        with torch.no_grad():
            for n in rows:
                params[n].add_(d[n], alpha=GRAD_H)
            up = loss_at()
            for n in rows:
                params[n].copy_(saved[n]).add_(d[n], alpha=-GRAD_H)
            down = loss_at()
            for n in rows:
                params[n].copy_(saved[n])
        out[name] = (d, (up - down) / (2 * GRAD_H))
    return out


def check_directions(tag: str, checks: dict, grads: dict) -> list:
    """Groups whose <g, d> misses the central difference by more than
    GRAD_RTOL of it plus GRAD_ATOL."""
    failed = []
    for name, (d, fd) in checks.items():
        dd = sum(float((grads[n].double() * d[n].double()).sum()) for n in d)
        ok = abs(dd - fd) <= GRAD_RTOL * abs(fd) + GRAD_ATOL
        log("train", f"{tag} {name:18s} <g, d> {dd: .6e}  central difference {fd: .6e}  "
            f"{'ok' if ok else 'REJECTED'}")
        if not ok:
            failed.append(name)
    return failed


def phase_train() -> dict:
    """The training path of qwen3-0.6b at full width; returns the
    ``flash_attention`` launches of scoring the trained weights, counted
    from zero at its start."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core import fit
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import train as train_mod
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train import StepConfig, build_eval_step
    from repro_torch.train_lm import profile_microbatch

    card = card_line()
    cfg = get_config("qwen3-0.6b")
    flash_attention.launches = 0
    n_params = sum(int(np.prod(s)) for s in (
        p.shape for p in tf.Transformer(cfg, device="meta").parameters()))
    log("train", f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}; {n_params / 1e6:.1f} M parameters, {2 * n_params / 1e9:.3f} GB "
        f"of bf16 weights, AdamW m and v in float32 ({8 * n_params / 1e9:.3f} GB); card {card}")

    # 1. launch/train.py: 50 steps at 8 x 512, checkpoints every 10, a
    # failure injected at step 25 (restored from step 20, steps 20-24 replayed).
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq"],
                      global_batch=TRAIN["batch"], seed=0, structure=0.9)
    timed = TimedCheckpoints()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        saved_cls, train_mod.CheckpointManager = train_mod.CheckpointManager, timed.cls
        try:
            t0 = time.perf_counter()
            out = train_mod.run_training(
                cfg, data, train_mod.TrainLoopConfig(
                    steps=TRAIN["steps"], ckpt_dir=tmp, ckpt_every=TRAIN["ckpt_every"],
                    keep=2, log_every=10, lr=TRAIN["lr"], fail_at_step=TRAIN["fail_at"]),
                device="cuda")
            wall = time.perf_counter() - t0
            peak_train = torch.cuda.max_memory_allocated()
            # the trained weights, from the final checkpoint
            model = tf.Transformer(cfg, device="cuda")
            optim_cfg = AdamWConfig(lr=TRAIN["lr"])
            template = train_mod.train_state(model, init_state(optim_cfg, dict(model.named_parameters())))
            (weights, opt_state), last = timed.cls(tmp).restore(None, template, device="cuda")
        finally:
            train_mod.CheckpointManager = saved_cls
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    del weights, opt_state, template
    losses, secs = out["losses"], out["step_seconds"]
    replayed = TRAIN["fail_at"] - TRAIN["fail_at"] // TRAIN["ckpt_every"] * TRAIN["ckpt_every"]
    first, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log("train", f"run_training: {len(losses)} steps recorded, last_step {out['last_step']}, "
        f"wall {wall:.1f} s; loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first 5 "
        f"{first:.4f}, of the last 5 {last5:.4f})")
    if not (out["last_step"] == TRAIN["steps"] == last
            and len(losses) == TRAIN["steps"] + replayed):
        raise AssertionError(f"run_training ended at {out['last_step']} with {len(losses)} "
                             f"steps, final checkpoint {last}; want {TRAIN['steps']} and "
                             f"{TRAIN['steps'] + replayed}")
    if not (all(math.isfinite(x) for x in losses) and last5 < first):
        raise AssertionError(f"the loss did not fall: first 5 {first}, last 5 {last5}")
    walls = timed.walls
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters()) + 8 * n_params + 4
    if len(walls["restore"]) != 2:  # the failure's restore, then the trained weights
        raise AssertionError(f"{len(walls['restore'])} restores, want 2: {walls}")
    log("train", f"checkpoints of the {n_bytes / 1e9:.3f} GB train state: "
        f"{len(walls['copy'])} async saves, host copy "
        f"{', '.join(f'{w:.2f}' for w in walls['copy'])} s, background write "
        f"{', '.join(f'{w:.2f}' for w in walls['write'])} s; final save "
        f"{', '.join(f'{w:.2f}' for w in walls['save'])} s; restores "
        f"{', '.join(f'{w:.2f}' for w in walls['restore'])} s")
    steady = sorted(secs[1:])
    med = steady[len(steady) // 2]
    tokens = TRAIN["batch"] * TRAIN["seq"]
    log("train", f"step time at {TRAIN['batch']} x {TRAIN['seq']}: first {secs[0] * 1e3:.1f} "
        f"ms, median {med * 1e3:.1f} ms (min {steady[0] * 1e3:.1f}, max {steady[-1] * 1e3:.1f}), "
        f"{tokens / med:.0f} tokens/s; peak memory {peak_train / 2**30:.2f} GiB; card {card}")

    # 2. Replay: 3 steps twice from one seed.
    def replay():
        return train_mod.run_training(
            cfg, data, train_mod.TrainLoopConfig(steps=3, log_every=0, lr=TRAIN["lr"]),
            device="cuda")["losses"]

    a, b = replay(), replay()
    how = "default algorithms"
    if not np.allclose(a, b, rtol=1e-6, atol=0):
        log("train", f"replay with the default algorithms differs: {a} vs {b}; again with "
            "torch.use_deterministic_algorithms(True), CUBLAS_WORKSPACE_CONFIG=:4096:8")
        import os
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        try:
            a, b = replay(), replay()
        finally:
            torch.use_deterministic_algorithms(False)
        how = "deterministic algorithms"
    if not np.allclose(a, b, rtol=1e-6, atol=0):
        raise AssertionError(f"replay is not deterministic: {a} vs {b}")
    log("train", f"replay ({how}): 3 steps twice from seed 0, losses "
        f"{', '.join(f'{x:.6f}' for x in a)} both times")

    # 3. The gradient on a float32 cut of the first TRAIN_CUT layers at full
    # width, against central differences; then with one layer's attention
    # gradient zeroed (what a kernel under autograd would do), rejected.
    cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT, param_dtype="float32",
                              compute_dtype="float32")
    small = tf.Transformer(cut, device="cuda")
    small.load_state_dict({n: t.float() for n, t in model.state_dict().items()
                           if not n.startswith("blocks.") or int(n.split(".")[1]) < TRAIN_CUT})
    batch = TokenPipeline(DataConfig(cfg.vocab_size, 128, 2, seed=5), device="cuda").batch_at(0)
    params = dict(small.named_parameters())
    loss = tf.loss_fn(small, cut, batch, wkv_kernel=False)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    checks = directional_check(lambda: float(tf.loss_fn(small, cut, batch)), params, grads,
                               grad_groups(list(params), TRAIN_CUT), seed=7)
    log("train", f"gradient check: {TRAIN_CUT}-layer float32 cut at full width, 2 x 128 "
        f"tokens, loss {float(loss.detach()):.6f}, relative step {GRAD_H}, tolerance {GRAD_RTOL} of the "
        f"central difference + {GRAD_ATOL}")
    failed = check_directions("autograd", checks, grads)
    if failed:
        raise AssertionError(f"autograd gradient misses central differences in {failed}")
    cut_layer = 1
    faulty = {n: (torch.zeros_like(g) if n.startswith(f"blocks.{cut_layer}.attn.") else g)
              for n, g in grads.items()}
    rejected = check_directions(f"layer {cut_layer} attention zeroed", checks, faulty)
    if rejected != [f"attn {cut_layer}"]:
        raise AssertionError(f"the check with layer {cut_layer}'s attention gradient zeroed "
                             f"rejected {rejected}, want only attn {cut_layer}")
    del small, params, grads, faulty, checks, loss
    torch.cuda.empty_cache()

    # 4. The paper's loop on the trainer: ms/step over the microbatch knob
    # at 16 x 512, the degree-2 fit, and the held-out knob predicted.
    prof = DataConfig(vocab_size=cfg.vocab_size, seq_len=PROFILE_SEQ,
                      global_batch=PROFILE_BATCH, seed=0, structure=0.9)
    peaks = {}
    times = {}
    for mb in PROFILE_KNOBS + (HELD_OUT_KNOB,):
        torch.cuda.reset_peak_memory_stats()
        times[mb] = profile_microbatch(cfg, prof, [mb], device="cuda", lr=TRAIN["lr"])[0]
        peaks[mb] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        log("train", f"microbatch {mb:2d} at {PROFILE_BATCH} x {PROFILE_SEQ}: "
            f"{times[mb] * 1e3:.1f} ms/step (mean of 3 after a warm-up), "
            f"{PROFILE_BATCH * PROFILE_SEQ / times[mb]:.0f} tokens/s, peak memory "
            f"{peaks[mb] / 2**30:.2f} GiB")
    # One 8 x 512 step under torch.profiler: launches and the device's busy share.
    from repro_torch.train import build_train_step
    prof_model = tf.init_params(cfg, seed=0, device="cuda")
    prof_state = init_state(optim_cfg, dict(prof_model.named_parameters()))
    train_step = build_train_step(cfg, optim_cfg)
    prof_batch = TokenPipeline(data, device="cuda").batch_at(0)
    prof_state, _ = train_step(prof_model, prof_state, prof_batch)  # warm-up

    def one_step():
        nonlocal prof_state
        prof_state, _ = train_step(prof_model, prof_state, prof_batch)

    profiled_breakdown(f"one train step at {TRAIN['batch']} x {TRAIN['seq']}", one_step)
    del prof_model, prof_state
    torch.cuda.empty_cache()
    knobs = np.asarray([[float(mb)] for mb in PROFILE_KNOBS])
    regr = fit(knobs, np.asarray([times[mb] for mb in PROFILE_KNOBS]), degree=2, scale=True,
               lam=1e-9, device="cuda")
    pred = float(regr.predict(np.asarray([[float(HELD_OUT_KNOB)]]), device="cuda").cpu()[0])
    err = abs(pred - times[HELD_OUT_KNOB]) / times[HELD_OUT_KNOB]
    log("train", f"fit over microbatch {list(PROFILE_KNOBS)} (degree 2): held-out microbatch "
        f"{HELD_OUT_KNOB} predicted {pred * 1e3:.1f} ms/step, measured "
        f"{times[HELD_OUT_KNOB] * 1e3:.1f} ms/step, error {err * 100:.1f} %; card {card}")
    if not (math.isfinite(pred) and pred > 0):
        raise AssertionError(f"the step-time model predicts {pred} s")

    # 5. The trained weights scored on a held-out batch through the kernels
    # and through the plain path.
    held = TokenPipeline(dataclasses.replace(data, seed=1), device="cuda").batch_at(10_000)
    before = flash_attention.launches
    scores = {}
    for use_flash in (True, False):
        score = build_eval_step(cfg, StepConfig(use_flash=use_flash))
        scores[use_flash] = float(score(model, held))
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # a second, warm call, timed
        score(model, held)
        torch.cuda.synchronize()
        scores[use_flash, "ms"] = (time.perf_counter() - t0) * 1e3
    launched = flash_attention.launches - before
    diff = abs(scores[True] - scores[False])
    log("train", f"trained weights scored on a held-out {TRAIN['batch']} x {TRAIN['seq']} batch: "
        f"flash_attention {scores[True]:.5f} ({scores[True, 'ms']:.1f} ms), plain path "
        f"{scores[False]:.5f} ({scores[False, 'ms']:.1f} ms), |diff| {diff:.2e} (tolerance "
        f"2e-2); the first 5 training losses averaged {first:.4f}")
    if not (math.isfinite(scores[True]) and diff <= 2e-2):
        raise AssertionError(f"scoring through the kernels {scores[True]} vs plain {scores[False]}")
    if launched != 2 * cfg.n_layers:
        raise AssertionError(f"scoring launched flash_attention {launched} times, want "
                             f"{2 * cfg.n_layers}")
    log("train", f"peak device memory: training {peak_train / 2**30:.2f} GiB, profile "
        + ", ".join(f"mb {mb} {peaks[mb] / 2**30:.2f}" for mb in sorted(peaks)) + " GiB")
    del model
    torch.cuda.empty_cache()
    log("launches", f"train path ({cfg.name}): flash_attention {flash_attention.launches} "
        f"({cfg.n_layers} x 2 scoring calls; the train steps take the plain route)")
    return {"flash_attention": flash_attention.launches}


# ---------------------------------------------------------------- MoE, Mamba

def no_drop(cfg):
    """``cfg`` with an MoE capacity factor of E / K, at which a group's
    capacity is all its tokens and nothing drops (itself without MoE)."""
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=max(m.capacity_factor, m.n_experts / m.top_k)))


def moe_drops(model, cfg, tag: str) -> None:
    """Dropping at the production capacity factor, on the first MoE layer's
    real input for 8 x 2048 tokens (the attention sub-block on the plain
    path, so no kernel launch is counted here): the kept slots equal the
    reference's construction (per choice k, a cumsum of the k-th choices'
    one-hot over the tokens plus the earlier choices' counts, kept below
    the capacity), each expert of each group keeps min(load, capacity);
    the tokens that kept all K choices get the same output as at E / K (no
    drop), to the bfloat16 GEMMs' rounding."""
    from repro_torch.models import moe
    from repro_torch.models.layers import rmsnorm

    blk = model.blocks[0]
    cdt = getattr(torch, cfg.compute_dtype)
    g = torch.Generator(device="cuda").manual_seed(13)
    tokens = torch.randint(0, cfg.vocab_size, (8, 2048), generator=g, device="cuda")
    x = F.embedding(tokens, model.embed)
    y, _ = blk.attn(rmsnorm(x, blk.norm1, cfg.norm_eps), cfg=cfg, use_flash=False)
    h = rmsnorm(x + y.to(x.dtype), blk.norm2, cfg.norm_eps)
    params = dict(blk.moe.named_parameters())
    a = moe.assign(h, params["router"], cfg)
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    counts, keep_ref = torch.zeros((a.G, 1, E), dtype=torch.long, device="cuda"), []
    for k in range(K):
        mk = F.one_hot(a.idx[..., k], E)                          # (G, T, E)
        pos_k = torch.cumsum(mk, dim=1) - mk + counts
        keep_ref.append(pos_k.gather(2, a.idx[..., k:k + 1])[..., 0] < a.cap)
        counts = counts + mk.sum(1, keepdim=True)
    if not torch.equal(a.keep, torch.stack(keep_ref, -1)):
        raise AssertionError(f"{tag}: kept slots differ from the k-major cumsum construction")
    load = F.one_hot(a.idx, E).sum((1, 2))                       # (G, E)
    kept = (F.one_hot(a.idx, E) * a.keep[..., None]).sum((1, 2))
    if not torch.equal(kept, load.clamp(max=a.cap)):
        raise AssertionError(f"{tag}: kept slots per expert differ from min(load, capacity)")
    y_prod, _ = moe.moe_ffn_grouped(h, params, cfg, cdt)
    y_all, _ = moe.moe_ffn_grouped(h, params, no_drop(cfg), cdt)
    full = a.keep.all(-1).view(8, 2048)
    diff = (y_prod.float() - y_all.float()).abs().amax(-1)
    scale = float(y_all.float().abs().max())
    err_kept = float(diff[full].max()) if full.any() else 0.0
    dropped = int((~a.keep).sum())
    log(tag, f"MoE dropping at capacity factor {cfg.moe.capacity_factor} on layer 0 of "
        f"8 x 2048 tokens ({a.G} group(s) of {a.T}, capacity {a.cap} a group, {E} experts, "
        f"top-{K}): {dropped} of {a.keep.numel()} slots dropped ({dropped / a.keep.numel():.2%}), "
        f"{int((~full).sum())} tokens lost a choice; expert loads {int(load.min())}-"
        f"{int(load.max())}; tokens that kept every choice vs E / K (no drop): max abs err "
        f"{err_kept:.3e} (output scale {scale:.3f}); tokens that lost one: median change "
        f"{float(diff[~full].median()) if (~full).any() else 0.0:.3e}")
    if err_kept > 2e-2 * scale:
        raise AssertionError(f"{tag}: tokens that dropped nothing differ from the no-drop "
                             f"output by {err_kept}")


@contextlib.contextmanager
def mamba_held(stats: dict):
    """Holds every one-step Mamba scan (a decode step) against the plain
    chunked scan on the same inputs padded to a 256-step chunk of identity
    steps (dt = 0), the reference's form: output and state, relative to
    their scales, kept in ``stats`` as (calls, max err)."""
    from repro_torch.models import ssm

    plain = ssm._selective_scan_chunked

    def call(h0, dt, dtx, A, B_seq, C_seq, chunk=256):
        y, h = plain(h0, dt, dtx, A, B_seq, C_seq, chunk)
        if dt.shape[1] == 1:
            pad = functools.partial(F.pad, pad=(0, 0, 0, chunk - 1))
            y_ref, h_ref = plain(h0, pad(dt), pad(dtx), A, pad(B_seq), pad(C_seq), chunk)
            err = max(float((y - y_ref[:, :1]).abs().max() / y_ref.abs().max()),
                      float((h - h_ref).abs().max() / h_ref.abs().max()))
            if not err <= 1e-6:
                raise AssertionError(f"a Mamba decode step differs from the chunked scan by {err}")
            n, e = stats.get("mamba step", (0, 0.0))
            stats["mamba step"] = (n + 1, max(e, err))
        return y, h

    ssm._selective_scan_chunked = call
    try:
        yield
    finally:
        ssm._selective_scan_chunked = plain


#: jamba-v0.1-52b on the card: one 8-layer period (32 layers are about
#: 105 GB in bf16; one period about 26.5 GB)
JAMBA_CUT = 8


def phase_jamba() -> dict:
    """jamba-v0.1-52b's serving path at full width, one period: prefill and
    decode through the seven Mamba layers' states and the attention
    layer's cache; returns the attention launches it made, counted from
    zero, one per decode_step or kernel-path forward call."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import transformer as tf

    tag = "jamba"
    full_cfg = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full_cfg, n_layers=JAMBA_CUT)
    V = cfg.vocab_size
    n_attn = cfg.layer_kinds().count("attn")
    decode_attention.launches = 0
    flash_attention.launches = 0
    steps = forwards = 0
    t0 = time.perf_counter()
    model = tf.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(tag, f"{cfg.name}: {cfg.n_layers} of {full_cfg.n_layers} layers (one period "
        f"{'/'.join(cfg.block_pattern)}; MoE {cfg.moe.n_experts} experts top-"
        f"{cfg.moe.top_k} of {cfg.moe.d_ff_expert} on the odd positions, n_groups "
        f"{cfg.moe.n_groups}), d_model {cfg.d_model}, Mamba d_in "
        f"{cfg.mamba_expand * cfg.d_model} d_state {cfg.mamba_d_state}; {n_bytes / 1e9:.3f} GB "
        f"of weights drawn on the card in {time.perf_counter() - t0:.1f} s (all 32 layers: "
        f"{n_bytes / 1e9 * full_cfg.n_layers / cfg.n_layers:.0f} GB without the embedding's "
        f"share, more than the card's 80 GB)")

    server = BatchedServer(cfg, model)
    latency = server.profile_latency_model()
    steps += len(server.profiled) * TOKEN_LATENCY_STEPS
    for b, t in server.profiled.items():
        log(tag, f"profile batch {b}: {t * 1e3:.3f} ms/token")
    batch = server.pick_batch_for_slo(latency, 50e-3)
    log(tag, f"fit: train MAPE {latency.train_mape:.2f}%, R^2 {latency.r2:.4f}; "
        f"SLO 50 ms/token -> predicted max batch {batch}")
    g = torch.Generator(device="cuda")
    done = 0
    while done < 8:
        b = min(batch, 8 - done)
        prompts = torch.randint(0, V, (b, 8), generator=g.manual_seed(done), device="cuda")
        toks, per_tok = server.serve(prompts, 16)
        steps += 16
        if toks.shape != (b, 16) or int(toks.min()) < 0 or int(toks.max()) >= V:
            raise AssertionError(f"served tokens out of range: {tuple(toks.shape)}")
        done += b
        log(tag, f"served {b} requests of 8-token prompts, 16 new tokens: "
            f"{per_tok * 1e3:.3f} ms/token ({done}/8 done)")

    long_server = BatchedServer(cfg, model, max_len=4096)
    prompts = torch.randint(0, V, (8, 2048), generator=g.manual_seed(7), device="cuda")
    long_server.serve(prompts[:, :64], 4)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    toks, per_tok = long_server.serve(prompts, 32)
    steps += 4 + 32
    peak = torch.cuda.max_memory_allocated()
    log(tag, f"8 requests of 2048-token prompts, max_len 4096 (one attention layer's KV cache "
        f"{8 * 4096 * n_attn * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2 / 1e9:.3f} GB, "
        f"seven Mamba states {7 * 8 * cfg.mamba_expand * cfg.d_model * (cfg.mamba_d_state * 4 + 3 * 2) / 1e9:.3f} GB), "
        f"32 new tokens: prefill {long_server.last_prefill_s * 1e3:.1f} ms "
        f"({8 * 2048 / long_server.last_prefill_s:.0f} tokens/s), decode "
        f"{per_tok * 1e3:.3f} ms/token; peak device memory {peak / 2**30:.2f} GiB")
    if toks.shape != (8, 32):
        raise AssertionError(f"long-prompt batch returned {tuple(toks.shape)}")
    prefills = []
    for _ in range(3):
        long_server.serve(prompts, 1)
        prefills.append(long_server.last_prefill_s)
    steps += 3
    log(tag, f"prefill of the same 8 x 2048-token prompts, three more times: "
        f"{', '.join(f'{t * 1e3:.1f}' for t in prefills)} ms")
    profiled_breakdown(f"{cfg.name} ({JAMBA_CUT} layers) prefill of the 8 x 2048-token prompts",
                       lambda: long_server.serve(prompts, 1))
    steps += 1
    del long_server
    torch.cuda.empty_cache()

    # Prefill 16 + 8 decode steps against the forward pass, at E / K (no
    # drop), every attention call held against its plain version and every
    # Mamba decode step against the plain chunked scan.  In bf16, top-2
    # routing turns the rounding of another GEMM shape into another expert
    # at near-ties, so decode vs forward there is printed; it is held in
    # float32 (the same weights, a float32 residual stream and float32
    # compute), and the bf16 forward is held against the path with the
    # attention's plain versions within twice its floor (that path against
    # itself with the softmax scale moved by 2^-20), as in phase_serve.
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention_ref

    ccfg = no_drop(cfg)
    held: dict = {}
    tokens = torch.randint(0, V, (2, 24), generator=g.manual_seed(11), device="cuda")
    with attention_swapped(*held_against_plain(held)), mamba_held(held):
        full, _ = tf.forward(model, ccfg, {"tokens": tokens}, use_flash=True)
        dec = teacher_forced(model, ccfg, tokens, 16)
    forwards, steps = forwards + 1, steps + 9
    with attention_swapped(decode_attention_ref, flash_attention_ref):
        full_ref, _ = tf.forward(model, ccfg, {"tokens": tokens}, use_flash=True)
    with attention_swapped(decode_attention_ref, functools.partial(
            flash_attention_ref, sm_scale=(1 + 2**-20) * cfg.resolved_head_dim**-0.5)):
        _, floor_rel = logits_err(
            tf.forward(model, ccfg, {"tokens": tokens}, use_flash=True)[0], full_ref, V)
    plain, _ = tf.forward(model, ccfg, {"tokens": tokens}, use_flash=False)
    err_dec, rel_dec = logits_err(dec, full[:, 15:], V)
    err_full, rel_full = logits_err(full, full_ref, V)
    err_plain, rel_plain = logits_err(full, plain, V)
    _, rel_ref_plain = logits_err(full_ref, plain, V)
    limit = max(5e-2, 2 * floor_rel)
    log(tag, f"bf16: prefill 16 + 8 decode steps vs forward at each position: max abs err "
        f"{err_dec:.3e}, relative norm {rel_dec:.3e} (routing flips, not held); kernel path vs "
        f"its plain versions' path: max abs err {err_full:.3e}, relative norm {rel_full:.3e} "
        f"(tolerance {limit:.3g}; floor, relative norm {floor_rel:.3e}); vs the plain path "
        f"(_sdpa): max abs err {err_plain:.3e}, relative norm {rel_plain:.3e}, the plain "
        f"versions' {rel_ref_plain:.3e}; logits scale {float(full[..., :V].float().abs().max()):.2f}")
    if not (rel_full <= limit and rel_plain <= max(limit, 2 * rel_ref_plain)):
        raise AssertionError(f"jamba kernels vs their plain versions {rel_full}, vs the plain "
                             f"path {rel_plain} (plain versions {rel_ref_plain}), floor {floor_rel}")
    del full, full_ref, dec, plain
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(ccfg, compute_dtype="float32")
    embed = model.embed
    model.embed = torch.nn.Parameter(embed.float(), requires_grad=False)
    try:
        with attention_swapped(*held_against_plain(held)), mamba_held(held):
            full, _ = tf.forward(model, cfg32, {"tokens": tokens}, use_flash=True)
            dec = teacher_forced(model, cfg32, tokens, 16)
    finally:
        model.embed = embed
    forwards, steps = forwards + 1, steps + 9
    err_dec, rel_dec = logits_err(dec, full[:, 15:], V)
    log(tag, f"float32: prefill 16 + 8 decode steps vs forward at each position: max abs err "
        f"{err_dec:.3e}, relative norm {rel_dec:.3e} (tolerance 2e-2)")
    log(tag, "held on the same inputs, both runs: " + "; ".join(
        f"{name} {n} calls, max err {e[0]:.3e}" for name, (n, *e) in sorted(held.items()))
        + " (attention 5e-2 bf16, 2e-5 float32; a Mamba step vs the chunked scan 1e-6 of "
        "the scale)")
    if held.get("mamba step", (0,))[0] != 16 * cfg.layer_kinds().count("mamba"):
        raise AssertionError(f"held {held.get('mamba step')} Mamba steps, want 16 a layer")
    if not torch.allclose(dec[..., :V], full[:, 15:, :V], rtol=2e-2, atol=2e-2):
        raise AssertionError(f"jamba float32 decode differs from forward by {err_dec}")
    del full, dec
    torch.cuda.empty_cache()

    launches = {"decode_attention": decode_attention.launches,
                "flash_attention": flash_attention.launches}
    want = {"decode_attention": n_attn * steps, "flash_attention": n_attn * forwards}
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, want {want}")
    log("launches", f"{tag} path ({cfg.name}, {JAMBA_CUT} layers): decode_attention "
        f"{launches['decode_attention']} ({n_attn} x {steps} decode_step calls), "
        f"flash_attention {launches['flash_attention']} ({n_attn} x {forwards} forward calls)")
    serve_breakdown(server)
    del server, model
    torch.cuda.empty_cache()
    return launches


#: the [granite] train steps: granite-moe-1b-a400m at full width
GRANITE_TRAIN = dict(batch=8, seq=512, steps=10, lr=1e-3)
#: depth of granite's float32 cut whose gradient is held against central
#: differences
GRANITE_CUT = 2


def phase_granite_train() -> None:
    """granite-moe-1b-a400m's training path at full width: a few steps of
    ``run_training`` at 8 x 512 (the loss with the aux; each forward's aux
    recorded, positive and finite), then a float32 cut's loss against its
    cross-entropy plus the weighted aux, and its gradients of each router,
    one expert, an attention layer and the embedding against central
    differences."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import train as train_mod
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import cross_entropy_loss

    tag = "granite"
    card = card_line()
    cfg = get_config("granite-moe-1b-a400m")
    run = GRANITE_TRAIN
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=run["seq"], global_batch=run["batch"],
                      seed=0, structure=0.9)
    auxes = []
    forward = tf.forward

    def recorded(*args, **kwargs):
        out = forward(*args, **kwargs)
        auxes.append(out[1].detach())
        return out

    tf.forward = recorded
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        out = train_mod.run_training(cfg, data, train_mod.TrainLoopConfig(
            steps=run["steps"], log_every=5, lr=run["lr"]), device="cuda")
        wall = time.perf_counter() - t0
    finally:
        tf.forward = forward
    peak = torch.cuda.max_memory_allocated()
    auxes = [float(a) for a in auxes]
    losses, secs = out["losses"], out["step_seconds"]
    steady = sorted(secs[1:])
    med = steady[len(steady) // 2]
    tokens = run["batch"] * run["seq"]
    log(tag, f"run_training: {len(losses)} steps at {run['batch']} x {run['seq']} in "
        f"{wall:.1f} s, loss (with {cfg.moe.router_aux_weight} x aux) {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; aux (summed over {cfg.n_layers} layers) {auxes[0]:.4f} -> "
        f"{auxes[-1]:.4f}; step time first {secs[0] * 1e3:.1f} ms, median {med * 1e3:.1f} ms "
        f"(min {steady[0] * 1e3:.1f}, max {steady[-1] * 1e3:.1f}), {tokens / med:.0f} tokens/s; "
        f"peak memory {peak / 2**30:.2f} GiB; card {card}")
    if not (out["last_step"] == run["steps"] and len(auxes) == len(losses) == run["steps"]
            and all(map(math.isfinite, losses + auxes)) and min(auxes) > 0):
        raise AssertionError(f"granite training: last step {out['last_step']}, losses {losses}, "
                             f"aux {auxes}")

    # The gradient of a float32 cut of the first GRANITE_CUT layers at full
    # width (seed-0 weights) against central differences: each layer's
    # router, one expert of layer 0, layer 0's attention, the embedding;
    # then with layer 1's router gradient zeroed, rejected.
    cut = dataclasses.replace(cfg, n_layers=GRANITE_CUT, param_dtype="float32",
                              compute_dtype="float32")
    small = tf.init_params(cut, seed=0, device="cuda")
    batch = TokenPipeline(DataConfig(cfg.vocab_size, 32, 2, seed=5), device="cuda").batch_at(0)
    params = dict(small.named_parameters())
    loss = tf.loss_fn(small, cut, batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    with torch.no_grad():
        logits, aux = tf.forward(small, cut, batch)
        xent = float(cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:]))
    gap = float(loss.detach()) - xent - cut.moe.router_aux_weight * float(aux)
    log(tag, f"{GRANITE_CUT}-layer float32 cut: loss {float(loss.detach()):.6f} = cross-entropy "
        f"{xent:.6f} + {cut.moe.router_aux_weight} x aux {float(aux):.6f} (diff {gap:.1e})")
    if not abs(gap) <= 1e-5:
        raise AssertionError(f"the loss is not cross-entropy + weighted aux: {gap}")
    # Top-k routing makes the loss piecewise smooth, and autograd's gradient
    # is that of the piece the routing picks: the central differences keep
    # each MoE layer's experts and kept slots as at theta (the gates and the
    # aux follow the perturbed router's probabilities).
    routes: list = []
    calls: list = []
    assign = moe.assign

    def recorded(*args, **kwargs):
        routes.append(assign(*args, **kwargs))
        return routes[-1]

    def frozen(x, router, cfg_):
        a = routes[calls.pop(0)]
        E = cfg_.moe.n_experts
        probs = torch.softmax(x.reshape(a.G, a.T, -1).float() @ router.float(), dim=-1)
        gates = probs.gather(-1, a.idx)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        top1 = F.one_hot(a.idx[..., 0], E).float().mean(-2)
        return a._replace(gates=gates, aux=E * torch.mean(top1 * probs.mean(-2)))

    def loss_at():
        calls[:] = range(len(routes))
        return float(tf.loss_fn(small, cut, batch))

    e = 5 % cfg.moe.n_experts
    groups = {"router 0": ["blocks.0.moe.router"], "router 1": ["blocks.1.moe.router"],
              f"expert {e} of layer 0": {f"blocks.0.moe.{w}": e
                                         for w in ("w_gate", "w_up", "w_down")},
              "attn 0": [n for n in params if n.startswith("blocks.0.attn.")],
              "embed + final_norm": ["embed", "final_norm"]}
    try:
        moe.assign = recorded
        with torch.no_grad():
            base = float(tf.loss_fn(small, cut, batch))
        moe.assign = frozen
        with torch.no_grad():
            if abs(loss_at() - base) > 1e-6 * abs(base):
                raise AssertionError("the held routing does not give the loss at theta")
        checks = directional_check(loss_at, params, grads, groups, seed=7)
    finally:
        moe.assign = assign
    log(tag, f"gradient check: {GRANITE_CUT}-layer float32 cut at full width, 2 x 32 tokens, "
        f"loss {float(loss.detach()):.6f} (with the aux), routing held at theta's, relative "
        f"step {GRAD_H}, tolerance {GRAD_RTOL} of the central difference + {GRAD_ATOL}")
    failed = check_directions(f"{tag} autograd", checks, grads)
    if failed:
        raise AssertionError(f"granite's autograd gradient misses central differences in {failed}")
    faulty = {n: (torch.zeros_like(g) if n == "blocks.1.moe.router" else g)
              for n, g in grads.items()}
    rejected = check_directions(f"{tag} router 1 zeroed", checks, faulty)
    if rejected != ["router 1"]:
        raise AssertionError(f"the check with router 1's gradient zeroed rejected {rejected}")
    del small, params, grads, faulty, checks
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- VLM, audio

#: [internvl]: 8 prompts of 256 patch embeddings and 2048 text tokens into
#: a 4096-slot cache, 32 new tokens; the float32 cut's depth
VLM_SERVE = dict(batch=8, text=2048, max_len=4096, new=32)
VLM_F32_CUT = 4


def phase_internvl() -> dict:
    """internvl2-26b's serving path at full width and depth (48 layers,
    39.8 GB of bf16 weights) through the step builders of ``train/step.py``
    (``BatchedServer`` takes tokens only, as the reference's): a prefill of
    patches + text, greedy decode steps with an empty patch prefix; then
    the kernel-path checks of phase 13 on a prompt of 256 patches + 24
    tokens and text-only scoring of 256 + 2048 positions.  Returns the
    attention launches it made, counted from zero, one a layer for each
    decode_step (the prefill is one) and each kernel-path forward call."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer as tf
    from repro_torch.train import StepConfig, build_decode_step, build_prefill_step

    tag = "internvl"
    cfg = get_config("internvl2-26b")
    V, P, L = cfg.vocab_size, cfg.n_patches, cfg.n_layers
    run = VLM_SERVE
    B = run["batch"]
    decode_attention.launches = 0
    flash_attention.launches = 0
    steps = forwards = 0
    t0 = time.perf_counter()
    model = tf.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(tag, f"{cfg.name}: {L} layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads of {cfg.resolved_head_dim} (G = {cfg.n_heads // cfg.n_kv_heads}), vocab "
        f"{cfg.vocab_size}, {P} patch embeddings of width {cfg.embed_in_dim}; "
        f"{n_bytes / 1e9:.3f} GB of bf16 weights drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda")
    patches = torch.randn((B, P, cfg.embed_in_dim), generator=gen.manual_seed(8),
                          device="cuda")
    tokens = torch.randint(0, V, (B, run["text"]), generator=gen.manual_seed(7), device="cuda")
    empty = patches[:, :0]
    prefill = build_prefill_step(cfg, run["max_len"], StepConfig(use_flash=True))
    decode = build_decode_step(cfg, StepConfig(use_flash=True))

    def serve(text, n_new):
        """Greedy: (new tokens, state, prefill s, decode s a token)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = prefill(model, {"tokens": text, "patches": patches})
        nxt = logits[:, -1, :V].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        out = [nxt]
        for _ in range(n_new - 1):
            logits, state = decode(model, state, {"tokens": nxt, "patches": empty})
            nxt = logits[:, -1, :V].argmax(-1, keepdim=True)
            out.append(nxt)
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t0 - t_pre) / max(n_new - 1, 1)
        return torch.cat(out, dim=1), state, t_pre, t_dec

    serve(tokens[:, :64], 4)  # warm-up
    steps += 4
    torch.cuda.reset_peak_memory_stats()
    toks, state, t_pre, t_dec = serve(tokens, run["new"])
    steps += run["new"]
    S = P + run["text"]
    kv_gb = B * run["max_len"] * L * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2 / 1e9
    log(tag, f"{B} prompts of {P} patches + {run['text']} tokens, max_len {run['max_len']} "
        f"(KV cache {kv_gb:.2f} GB), {run['new']} new tokens: prefill {t_pre * 1e3:.1f} ms "
        f"({B * S / t_pre:.0f} positions/s), decode {t_dec * 1e3:.3f} ms/token at batch {B}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if (toks.shape != (B, run["new"]) or int(toks.min()) < 0 or int(toks.max()) >= V
            or state.pos != S + run["new"] - 1):
        raise AssertionError(f"served tokens {tuple(toks.shape)}, state at {state.pos}")
    prefills = []
    for _ in range(3):  # the prefill alone
        prefills.append(serve(tokens, 1)[2])
    steps += 3
    log(tag, f"prefill of the same {B} x ({P} + {run['text']}) prompts, three more times: "
        f"{', '.join(f'{t * 1e3:.1f}' for t in prefills)} ms")
    profiled_breakdown(f"{cfg.name} prefill of the {B} x ({P} + {run['text']}) prompts",
                       lambda: prefill(model, {"tokens": tokens, "patches": patches}))
    step = {"tokens": toks[:, -1:], "patches": empty}
    profiled_breakdown(f"{cfg.name} decode step, batch {B}, {state.pos} cached positions",
                       lambda: decode(model, state, step))
    steps += 2
    del state, toks
    torch.cuda.empty_cache()

    # The kernel path on 256 patches + 24 tokens (decode vs forward, each
    # call held, the logits against the plain versions' path and the plain
    # path, a float32 cut), then text-only scoring of 256 + 2048 positions.
    small = tokens[:2, :24]
    checks = check_kernel_path(model, cfg, tag, small, patches[:2], VLM_F32_CUT)
    forwards += check_scoring(model, cfg, tag, {"tokens": tokens[:1], "patches": patches[:1]})
    launches = path_launches(tag, cfg, steps, forwards, checks)
    del model
    torch.cuda.empty_cache()
    return launches


#: [hubert]: 8 x 2048 frames to encode, the share of labels at -100, and
#: the train steps at 8 x 512 (lr with a float32 master copy)
AUDIO_ENCODE = dict(batch=8, frames=2048, masked=0.1)
AUDIO_TRAIN = dict(batch=8, frames=512, steps=10, lr=1e-3)
#: depth of hubert's float32 cut whose gradient is held against central
#: differences
AUDIO_CUT = 2


def phase_hubert() -> dict:
    """hubert-xlarge at full width and depth (48 layers, head_dim 80,
    non-causal): 8 x 2048 frames encoded through the encoder's prefill step
    on the kernel path, each ``flash_attention`` call held against its plain
    version, the logits against the plain versions' path (with its floor)
    and the plain path, the per-frame loss with about 10 % of the labels
    at -100, kernels against plain; then 10 train steps at 8 x 512 through
    ``build_train_step`` on the plain routes, on labels that are a fixed
    function of the frames (the argmax of a fixed random projection), the
    loss falling; then a 2-layer float32 cut's gradient per group
    (``in_proj``, one attention, ``lm_head``) against central differences,
    a zeroed attention gradient rejected.  Returns the attention launches
    of the encode path, counted from zero: one a layer for each kernel-path
    forward call."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train import StepConfig, build_eval_step, build_prefill_step, build_train_step

    tag = "hubert"
    card = card_line()
    cfg = get_config("hubert-xlarge")
    V, L = cfg.vocab_size, cfg.n_layers
    decode_attention.launches = 0
    flash_attention.launches = 0
    forwards = 0
    t0 = time.perf_counter()
    model = tf.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(tag, f"{cfg.name}: {L} layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.resolved_head_dim}, non-causal, {cfg.vocab_size} targets (padded to "
        f"{cfg.vocab_padded}), frame embeddings of width {cfg.embed_in_dim}, no token "
        f"embedding; {n_bytes / 1e9:.3f} GB of bf16 weights drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    run = AUDIO_ENCODE
    B, S = run["batch"], run["frames"]
    gen = torch.Generator(device="cuda")
    frames = torch.randn((B, S, cfg.embed_in_dim), generator=gen.manual_seed(3), device="cuda")
    batch = {"embeds": frames}
    encode = build_prefill_step(cfg, S, StepConfig(use_flash=True))
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(4):  # the first, then three more
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = encode(model, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    forwards += 4
    peak = torch.cuda.max_memory_allocated()
    if (logits.shape != (B, S, cfg.vocab_padded) or not torch.isfinite(logits[..., :V]).all()
            or not (logits[..., V:].float() < -1e20).all()):
        raise AssertionError(f"encode: logits {tuple(logits.shape)}, finite and pad-masked?")
    log(tag, f"encode {B} x {S} frames (prefill step, kernel path): "
        f"{', '.join(f'{w * 1e3:.2f}' for w in walls)} ms (first, then three more), "
        f"{B * S / min(walls[1:]):.0f} frames/s; peak device memory {peak / 2**30:.2f} GiB; "
        f"card {card}")
    profiled_breakdown(f"{cfg.name} encode of {B} x {S} frames", lambda: encode(model, batch))
    forwards += 1

    # The kernel path against the plain versions' path, its floor and the
    # plain path; every flash_attention call held against its plain version.
    held: dict = {}
    with attention_swapped(*held_against_plain(held)):
        got = encode(model, batch)
    forwards += 1
    with attention_swapped(decode_attention_ref, flash_attention_ref):
        want = encode(model, batch)
    with attention_swapped(decode_attention_ref, functools.partial(
            flash_attention_ref, sm_scale=(1 + 2**-20) * cfg.resolved_head_dim**-0.5)):
        floor, floor_rel = logits_err(encode(model, batch), want, V)
    plain = build_prefill_step(cfg, S)(model, batch)
    err, rel = logits_err(got, want, V)
    err_plain, rel_plain = logits_err(got, plain, V)
    _, rel_ref_plain = logits_err(want, plain, V)
    del got, want, plain
    n, e, r = held["flash_attention"]
    log(tag, f"{n} flash_attention calls vs their plain versions: max abs err {e:.3e}, row "
        f"err {r:.3e} (tolerance 5e-2, rows 1e-2); {L}-layer logits vs the plain versions' "
        f"path max abs err {err:.3e} (relative norm {rel:.3e}), floor {floor:.3e} (relative "
        f"norm {floor_rel:.3e}; tolerance {max(5e-2, 2 * floor):.3g}, relative norm 5e-2); "
        f"vs the plain path (_sdpa) max abs err {err_plain:.3e}, relative norm "
        f"{rel_plain:.3e} (tolerance 5e-2; the plain versions' {rel_ref_plain:.3e})")
    if not (err <= max(5e-2, 2 * floor) and rel <= 5e-2 and rel_plain <= 5e-2):
        raise AssertionError(f"encode logits: kernels vs plain versions {err} (relative norm "
                             f"{rel}), floor {floor}; vs the plain path {rel_plain}")

    # The per-frame loss, about 10 % of the labels masked.
    labels = torch.randint(0, V, (B, S), generator=gen.manual_seed(4), device="cuda")
    masked = torch.rand((B, S), generator=gen, device="cuda") < run["masked"]
    labels[masked] = -100
    scored = {"embeds": frames, "labels": labels}
    loss = float(build_eval_step(cfg, StepConfig(use_flash=True, logits_chunk=512))(
        model, scored))
    forwards += 1
    ref = float(build_eval_step(cfg, StepConfig(logits_chunk=512))(model, scored))
    log(tag, f"per-frame loss, {int(masked.sum())} of {B * S} labels at -100: kernels "
        f"{loss:.5f}, plain path {ref:.5f} (|diff| {abs(loss - ref):.2e}, tolerance 2e-2)")
    if not (math.isfinite(loss) and abs(loss - ref) <= 2e-2):
        raise AssertionError(f"per-frame loss {loss} vs plain {ref}")

    launches = {"decode_attention": decode_attention.launches,
                "flash_attention": flash_attention.launches}
    want_launches = {"decode_attention": 0, "flash_attention": L * forwards}
    if launches != want_launches:
        raise AssertionError(f"{tag} launches {launches}, want {want_launches} ({L} per "
                             f"forward call, {forwards} calls)")
    log("launches", f"{tag} path ({cfg.name}): flash_attention {launches['flash_attention']} "
        f"({L} x {forwards} forward calls), decode_attention 0")
    del model, frames, batch, logits, labels, scored
    torch.cuda.empty_cache()

    # Train steps on the plain routes (the kernels have no backward).
    run = AUDIO_TRAIN
    model = tf.init_params(cfg, seed=0, device="cuda")
    optim_cfg = AdamWConfig(lr=run["lr"], master_fp32=True)
    opt_state = init_state(optim_cfg, dict(model.named_parameters()))
    train_step = build_train_step(cfg, optim_cfg, StepConfig())
    frames = torch.randn((run["batch"], run["frames"], cfg.embed_in_dim),
                         generator=gen.manual_seed(5), device="cuda")
    proj = torch.randn((cfg.embed_in_dim, V), generator=gen, device="cuda")
    batch = {"embeds": frames, "labels": (frames @ proj).argmax(-1).int()}
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(run["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt_state, metrics = train_step(model, opt_state, batch)
        losses.append(float(metrics["loss"]))
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(secs[1:])
    med = steady[len(steady) // 2]
    n_frames = run["batch"] * run["frames"]
    log(tag, f"{run['steps']} train steps at {run['batch']} x {run['frames']} (build_train_step, "
        f"plain routes, AdamW lr {run['lr']} with a float32 master copy; the schedule's first "
        f"step applies lr 0): loss {', '.join(f'{x:.4f}' for x in losses)}; step time first "
        f"{secs[0] * 1e3:.1f} ms, median {med * 1e3:.1f} ms (min {steady[0] * 1e3:.1f}, max "
        f"{steady[-1] * 1e3:.1f}), {n_frames / med:.0f} frames/s; peak memory "
        f"{peak / 2**30:.2f} GiB; card {card}")
    if not (all(map(math.isfinite, losses)) and sum(losses[-3:]) < sum(losses[:3])):
        raise AssertionError(f"hubert training: losses {losses} (finite, falling)")
    del model, opt_state, frames, batch
    torch.cuda.empty_cache()

    # The gradient of a float32 cut of the first AUDIO_CUT layers at full
    # width against central differences: in_proj, layer 0's attention,
    # lm_head; then with layer 0's attention gradient zeroed, rejected.
    cut = dataclasses.replace(cfg, n_layers=AUDIO_CUT, param_dtype="float32",
                              compute_dtype="float32")
    small = tf.init_params(cut, seed=0, device="cuda")
    frames = torch.randn((2, 64, cfg.embed_in_dim), generator=gen.manual_seed(6), device="cuda")
    labels = torch.randint(0, V, (2, 64), generator=gen, device="cuda")
    labels[:, ::10] = -100
    batch = {"embeds": frames, "labels": labels}
    params = dict(small.named_parameters())
    loss = tf.loss_fn(small, cut, batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    groups = {"in_proj": ["in_proj"],
              "attn 0": [n for n in params if n.startswith("blocks.0.attn.")],
              "lm_head": ["lm_head"]}
    with torch.no_grad():
        checks = directional_check(lambda: float(tf.loss_fn(small, cut, batch)), params,
                                   grads, groups, seed=7)
    log(tag, f"gradient check: {AUDIO_CUT}-layer float32 cut at full width, 2 x 64 frames "
        f"(every tenth label at -100), loss {float(loss.detach()):.6f}, relative step "
        f"{GRAD_H}, tolerance {GRAD_RTOL} of the central difference + {GRAD_ATOL}")
    failed = check_directions(f"{tag} autograd", checks, grads)
    if failed:
        raise AssertionError(f"hubert's autograd gradient misses central differences in {failed}")
    faulty = {n: (torch.zeros_like(g) if n.startswith("blocks.0.attn.") else g)
              for n, g in grads.items()}
    rejected = check_directions(f"{tag} attn 0 zeroed", checks, faulty)
    if rejected != ["attn 0"]:
        raise AssertionError(f"the check with attn 0's gradient zeroed rejected {rejected}")
    del small, params, grads, faulty, checks
    torch.cuda.empty_cache()
    return launches


#: the (1, 1) dry-run cell of qwen3-0.6b at phase 17's shape and StepConfig,
#: run in its own process (a fake world of one rank, no device)
CELL_1X1 = r"""
import json, sys, time
import torch.distributed as dist
from repro_torch.launch.dryrun import init_fake_world
t0 = time.perf_counter()
init_fake_world(1)
from repro_torch.configs import SHAPES, ShapeConfig
from repro_torch.launch import cells
from repro_torch.launch.mesh import make_mesh
batch, seq = int(sys.argv[1]), int(sys.argv[2])
SHAPES["train_smoke"] = ShapeConfig("train_smoke", "train", seq, batch)
mesh = make_mesh((1, 1), ("data", "model"))
cell = cells.CellConfig(remat="none", fsdp=False)
r = cells.analyze_cell(cells.build_cell("qwen3-0.6b", "train_smoke", mesh, cell=cell),
                       n_devices=1)
print(json.dumps({"roofline": r["roofline"], "memory": r["memory"],
                  "seconds": time.perf_counter() - t0}))
dist.destroy_process_group()
"""
SHARD_DECODE_STEPS = 8


def dry_run_procs(tmp: str) -> dict:
    """Start the two dry runs on the host CPU (no device), each in its own
    process: the 16 x 16 production mesh at 256 fake ranks, and the (1, 1)
    cell at phase 17's shape."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    cmds = {"16x16": [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                      "qwen3-0.6b", "--shape", "train_4k", "--mesh", "single", "--out", tmp],
            "1x1": [sys.executable, "-c", CELL_1X1, str(TRAIN["batch"]), str(TRAIN["seq"])]}
    return {k: (subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 env=env, cwd=ROOT), time.perf_counter())
            for k, c in cmds.items()}


def dry_run_result(name: str, proc, t0: float, timeout: float) -> tuple[str, float]:
    try:
        out, err = proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"dry run {name} passed its {timeout:.0f} s limit")
    if proc.returncode:
        raise AssertionError(f"dry run {name} exited {proc.returncode}: {err[-3000:]}")
    return out, time.perf_counter() - t0


def phase_sharding() -> dict:
    """qwen3-0.6b served and trained sharded, on a (1, 1) ("data", "model")
    mesh over an NCCL world of one rank, against the same weights without a
    mesh; the dry runs beside it.  Returns the attention launches of the
    sharded path, counted from zero."""
    import dataclasses
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, grad_compress, init_state
    from repro_torch.sharding import context, layout, rules
    from repro_torch.train import StepConfig, build_compressed_dp_train_step

    card = card_line()
    cfg = get_config("qwen3-0.6b")
    L = cfg.n_layers
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    procs = dry_run_procs(f"{tmp}/dry")
    torch.cuda.reset_peak_memory_stats()

    # Training without a mesh first (no process group yet): 5 steps from
    # phase 17's seed, its final checkpoint kept.
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq"],
                      global_batch=TRAIN["batch"], seed=0, structure=0.9)
    loop = train_mod.TrainLoopConfig(steps=5, ckpt_dir=f"{tmp}/plain", ckpt_every=5,
                                     log_every=0, lr=TRAIN["lr"])
    plain = train_mod.run_training(cfg, data, loop, device="cuda")

    model = tf.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(23)
    prompts = torch.randint(0, cfg.vocab_size, (8, 2048), generator=g, device="cuda")
    seq = torch.randint(0, cfg.vocab_size, (1, 2048), generator=g, device="cuda")

    def serve(m, mesh):
        """Prefill 8 x 2048 into 4096 slots, 8 greedy decode steps on the
        unsharded run's tokens, then 2048-token scoring; logits and walls."""
        out, walls = [], {}
        put = (lambda t: t) if mesh is None else (lambda t: layout.distribute(
            t, mesh, rules.batch_specs({"t": t}, rules.mesh_axes(mesh),
                                       rules.mesh_shape_of(mesh))["t"]))
        with torch.no_grad(), context.use_mesh(mesh):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state = tf.prefill(m, cfg, {"tokens": put(prompts)}, 4096, use_flash=True)
            torch.cuda.synchronize()
            walls["prefill"] = time.perf_counter() - t0
            out.append(layout.full(logits))
            t0 = time.perf_counter()
            feed = list(tokens_fed)  # the unsharded run's greedy tokens, once it has run
            for i in range(SHARD_DECODE_STEPS):
                nxt = feed[i] if feed else out[-1][:, -1:].argmax(-1)
                if not feed:
                    tokens_fed.append(nxt)
                logits, state = tf.decode_step(m, cfg, state, {"tokens": put(nxt)},
                                               use_flash=True)
                out.append(layout.full(logits))
            torch.cuda.synchronize()
            walls["decode"] = (time.perf_counter() - t0) / SHARD_DECODE_STEPS
            t0 = time.perf_counter()
            logits, _ = tf.forward(m, cfg, {"tokens": put(seq)}, use_flash=True)
            torch.cuda.synchronize()
            walls["score"] = time.perf_counter() - t0
            out.append(layout.full(logits))
        del state
        return out, walls

    tokens_fed: list = []
    serve(model, None)  # warm-up: the kernels' first calls
    want, plain_walls = serve(model, None)
    with nccl_world1():
        mesh = make_mesh((1, 1), ("data", "model"))
        axes, mesh_shape = rules.mesh_axes(mesh), rules.mesh_shape_of(mesh)
        sharded = tf.init_params(cfg, seed=0, device="cuda")
        specs = rules.param_specs(dict(sharded.named_parameters()), axes, fsdp=True,
                                  mesh_shape=mesh_shape)
        layout.shard_module(sharded, mesh, specs)
        decode_attention.launches = flash_attention.launches = 0
        serve(sharded, mesh)  # warm-up: DTensor's first sharding propagation of each op
        got, walls = serve(sharded, mesh)
        launches = {"decode_attention": decode_attention.launches,
                    "flash_attention": flash_attention.launches}
        expect = {"decode_attention": 2 * L * (1 + SHARD_DECODE_STEPS), "flash_attention": 2 * L}
        if launches != expect:
            raise AssertionError(f"sharded path launches {launches}, want {expect}")
        names = ["prefill"] + [f"decode {i}" for i in range(SHARD_DECODE_STEPS)] + ["scoring"]
        worst = 0.0
        for name, a, b in zip(names, got, want):
            if not torch.isfinite(a).all():
                raise AssertionError(f"sharded {name} logits not finite")
            rel = float((a.float() - b.float()).norm() / b.float().norm())
            worst = max(worst, rel)
            if rel > 5e-2:
                raise AssertionError(f"sharded {name} logits {rel:.3e} from the unsharded "
                                     f"path's (limit 5e-2)")
        n_equal = sum(bool(torch.equal(a, b)) for a, b in zip(got, want))
        log("sharding", f"{cfg.name} on a (1, 1) mesh over NCCL, fsdp param specs, caches "
            f"by decode_state_specs: prefill 8 x 2048 into 4096 slots, {SHARD_DECODE_STEPS} "
            f"decode steps, 2048-token scoring (each twice, the second timed); "
            f"{n_equal}/{len(names)} logits bit-equal to "
            f"the unsharded path's, worst relative norm {worst:.3e} (limit 5e-2); launches "
            f"{launches}")
        log("sharding", f"walls, sharded vs unsharded: prefill {walls['prefill'] * 1e3:.1f} "
            f"vs {plain_walls['prefill'] * 1e3:.1f} ms, decode {walls['decode'] * 1e3:.3f} vs "
            f"{plain_walls['decode'] * 1e3:.3f} ms/token, scoring {walls['score'] * 1e3:.1f} "
            f"vs {plain_walls['score'] * 1e3:.1f} ms; card {card}")
        del sharded, got, want, model

        # A 4-layer float32 cut through the kernels' float32 route.
        cut = dataclasses.replace(cfg, n_layers=4, param_dtype="float32",
                                  compute_dtype="float32")
        small = prompts[:2, :256]
        a_model = tf.init_params(cut, seed=0, device="cuda")
        b_model = tf.init_params(cut, seed=0, device="cuda")
        layout.shard_module(b_model, mesh, rules.param_specs(
            dict(b_model.named_parameters()), axes, fsdp=True, mesh_shape=mesh_shape))
        with torch.no_grad():
            la, _ = tf.prefill(a_model, cut, {"tokens": small}, 512, use_flash=True,
                               cache_dtype=torch.float32)
            with context.use_mesh(mesh):
                lb, _ = tf.prefill(b_model, cut, {"tokens": layout.distribute(
                    small, mesh, (("data",), None))}, 512, use_flash=True,
                    cache_dtype=torch.float32)
        rel = float((layout.full(lb) - la).norm() / la.norm())
        log("sharding", f"4-layer float32 cut, prefill 2 x 256 through the kernels: sharded "
            f"vs unsharded relative norm {rel:.3e} (limit 2e-5)")
        if rel > 2e-5:
            raise AssertionError(f"float32 cut {rel:.3e} past 2e-5")
        del a_model, b_model

        # Training on the mesh: the same 5 steps.
        t0 = time.perf_counter()
        out = train_mod.run_training(cfg, data, dataclasses.replace(
            loop, ckpt_dir=None), device="cuda", mesh=mesh)
        train_wall = time.perf_counter() - t0
        rel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], plain["losses"]))
        log("sharding", f"run_training(mesh) 5 steps at {TRAIN['batch']} x {TRAIN['seq']}: "
            f"losses {', '.join(f'{x:.6f}' for x in out['losses'])}; worst relative "
            f"difference from the unsharded trainer's {rel:.2e} (limit 1e-6); step ms "
            f"sharded {np.median(out['step_seconds'][1:]) * 1e3:.1f}, unsharded "
            f"{np.median(plain['step_seconds'][1:]) * 1e3:.1f}; wall {train_wall:.1f} s")
        if len(out["losses"]) != 5 or rel > 1e-6:
            raise AssertionError(f"sharded losses {out['losses']} vs {plain['losses']}")

        # The unsharded trainer's checkpoint restored onto the mesh, saved back.
        optim_cfg = AdamWConfig(lr=TRAIN["lr"])
        _, pspec, ospec = train_mod._make_sharded_step(cfg, optim_cfg, StepConfig(), mesh)
        like_model = tf.Transformer(cfg, device="cuda")
        like = train_mod.train_state(like_model, init_state(
            optim_cfg, dict(like_model.named_parameters())))
        src = CheckpointManager(f"{tmp}/plain")
        tree, step = src.restore(None, like, device="cuda", mesh=mesh,
                                 placements=(pspec, ospec))
        dst = CheckpointManager(f"{tmp}/resharded")
        dst.save(step, tree)
        a_dir, b_dir = Path(src._step_dir(step)), Path(dst._step_dir(step))
        files = sorted(p.name for p in a_dir.glob("arr_*.npy"))
        def same(f):
            a, b = np.load(a_dir / f), np.load(b_dir / f)
            return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()

        differ = [f for f in files if not same(f)]
        log("sharding", f"checkpoint of step {step} restored onto the mesh and saved back: "
            f"{len(files) - len(differ)}/{len(files)} leaves bit-equal")
        if differ or not files:
            raise AssertionError(f"re-sharded checkpoint leaves differ: {differ[:5]}")
        del tree, like, like_model

        # One compressed data-parallel step, mesh form against group= form.
        batch = TokenPipeline(data, device="cuda").batch_at(0)
        results = []
        for kw in ({"group": None}, {"mesh": mesh, "axis": "data"}):
            m = tf.init_params(cfg, seed=0, device="cuda")
            params = dict(m.named_parameters())
            step_fn = build_compressed_dp_train_step(cfg, optim_cfg, **kw)
            opt, err, metrics = step_fn(m, init_state(optim_cfg, params),
                                        grad_compress.init_error_state(params), batch)
            opt, err, metrics = step_fn(m, opt, err, TokenPipeline(
                data, device="cuda").batch_at(1))
            results.append(([p.detach().clone() for p in m.parameters()],
                            float(metrics["loss"])))
            del m, params, opt, err
        same = all(torch.equal(a, b) for a, b in zip(results[0][0], results[1][0]))
        log("sharding", f"compressed DP steps, mesh form vs group= form: weights "
            f"{'bit-equal' if same else 'DIFFER'}, losses {results[0][1]:.6f} / "
            f"{results[1][1]:.6f}")
        if not same or results[0][1] != results[1][1]:
            raise AssertionError("the mesh form of the compressed DP step is not bit-equal")
        del results
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("sharding", f"peak device memory of the phase {peak:.2f} GiB; card {card}")

    # The dry runs, started at the phase's start.
    out, wall = dry_run_result("16x16", *procs["16x16"], timeout=120)
    rec = json.loads((Path(tmp) / "dry" / "single_pod_16x16" /
                      "qwen3-0.6b__train_4k.json").read_text())
    roof, mem = rec["roofline"], rec["memory"]
    log("sharding", f"dry run 16 x 16 (256 fake ranks), qwen3-0.6b train_4k: compute "
        f"{roof['compute_s']:.4f} s, memory {roof['memory_s']:.4f} s, collective "
        f"{roof['collective_s']:.4f} s, dominant {roof['dominant']}, peak "
        f"{mem['peak_bytes'] / 2**30:.2f} GiB per device, step (no overlap) "
        f"{roof['step_time_no_overlap']:.4f} s; collective bytes by kind "
        f"{roof['collective_bytes_by_kind']}; the cell's dry run {rec['compile_seconds']:.1f} s, "
        f"joined after {wall:.1f} s")
    if not (roof["compute_s"] > 0 and roof["dominant"] in ("compute", "memory", "collective")):
        raise AssertionError(f"dry run 16x16: {roof}")
    out, wall = dry_run_result("1x1", *procs["1x1"], timeout=120)
    cell = json.loads(out.strip().splitlines()[-1])
    log("sharding", f"dry run of the (1, 1) cell at {TRAIN['batch']} x {TRAIN['seq']} "
        f"(phase 17's shape and StepConfig): step_time_no_overlap "
        f"{cell['roofline']['step_time_no_overlap'] * 1e3:.1f} ms (compute "
        f"{cell['roofline']['compute_s'] * 1e3:.1f}, memory "
        f"{cell['roofline']['memory_s'] * 1e3:.1f}), peak "
        f"{cell['memory']['peak_bytes'] / 2**30:.2f} GiB; measured on the card: step "
        f"{np.median(plain['step_seconds'][1:]) * 1e3:.1f} ms (this phase), peak "
        f"{peak:.2f} GiB; dry run {cell['seconds']:.1f} s, joined after {wall:.1f} s; "
        f"information only")
    tmp_dir.cleanup()
    return launches


#: the [examples] phase: each example's module, its smallest flags, and
#: what its printed lines that the phase repeats begin with
EXAMPLE_RUNS = (("mapreduce_wordcount", [], ("execution time",)),
                ("mapreduce_wordcount", ["--combiner", "--phase-times"],
                 ("execution time", "phase walls")),
                ("phase_breakdown", [], ("  composed (sum", "  monolithic")),
                ("cluster_sim", ["--real"], ("fifo-static", "predict-")),
                ("elastic_preempt", [], ("[elastic] snapshot", "[elastic] regrant")),
                ("serve_lm", [], ("decode vs", "predicted")))


def phase_examples() -> dict:
    """The port's examples, in-process on the card at their smallest flags
    (EXAMPLE_RUNS): each must run to its end (each checks its own result:
    the word count's total, the snapshot's bit-identical resume, serving's
    decode against its teacher-forced forward at 2e-2, the model
    database's round trip).  Each one's kernel launches and wall are
    printed with its chosen lines; the four kernels of the MapReduce and
    serving paths must each launch.  Returns the launches by kernel."""
    import contextlib
    import importlib
    import io

    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.local_reduce import local_reduce
    from repro_torch.kernels.segment_reduce import segment_reduce

    kernels = {"segment_reduce": segment_reduce, "local_reduce": local_reduce,
               "decode_attention": decode_attention, "flash_attention": flash_attention}
    for fn in kernels.values():
        fn.launches = 0
    for name, argv, shown in EXAMPLE_RUNS:
        main = importlib.import_module(f"repro_torch.{name}").main
        before = {k: fn.launches for k, fn in kernels.items()}
        out, t0 = io.StringIO(), time.perf_counter()
        with contextlib.redirect_stdout(out):
            main(argv)
        wall = time.perf_counter() - t0
        made = {k: fn.launches - before[k] for k, fn in kernels.items() if fn.launches > before[k]}
        lines = " | ".join(line.strip() for line in out.getvalue().splitlines()
                           if line.startswith(shown))
        log("examples", f"python -m repro_torch.{name} {' '.join(argv)}: {wall:.1f} s, "
            f"launches {made}; {lines}")
    total = {k: fn.launches for k, fn in kernels.items()}
    if min(total.values()) < 1:
        raise AssertionError(f"the examples left a kernel unlaunched: {total}")
    return total


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
        # A path that runs jobs in rank processes returns their launches too.
        want, ranks = want if isinstance(want, tuple) else (want, {})
        made = {name: fn.launches + ranks.get(name, 0)
                for name, fn in (("segment_reduce", segment_reduce),
                                 ("local_reduce", local_reduce))}
        if made != want:
            raise AssertionError(f"{path} path launches {made}, want {want}")
        log("launches", f"{path} path: segment_reduce {made['segment_reduce']}, local_reduce "
            f"{made['local_reduce']} (as its jobs' reduce waves, groups, slots or steps and "
            f"combiners), {time.perf_counter() - t_path:.1f} s")
        for name, n in made.items():
            launches[name] += n
    del apps
    torch.cuda.empty_cache()

    # The serving paths, qwen3-0.6b, gemma-7b (head_dim 256),
    # granite-moe-1b-a400m (MoE, head_dim 64), one period of jamba-v0.1
    # (Mamba, MoE) and internvl2-26b (patches + text, G = 6), each counted
    # from zero inside; serving records no autograd graph.
    with torch.no_grad():
        launches.update(phase_serve())
        torch.cuda.empty_cache()
        for path in (lambda: phase_serve("gemma-7b", tag="gemma", requests=8, long_new=32),
                     lambda: phase_serve("granite-moe-1b-a400m", tag="granite", requests=8,
                                         long_new=32),
                     phase_jamba, phase_internvl):
            t_path = time.perf_counter()
            for name, n in path().items():
                launches[name] += n
            torch.cuda.empty_cache()
            log("launches", f"path wall {time.perf_counter() - t_path:.1f} s")

    # The rwkv6-3b path: the WKV6 kernel alone, then serving and scoring,
    # counted from zero inside.
    report.update(phase_wkv6())
    with torch.no_grad():
        launches.update(phase_rwkv())
    torch.cuda.empty_cache()

    # The training path: qwen3-0.6b trained at full width, its scoring
    # launches counted from zero inside.
    t_train = time.perf_counter()
    train = phase_train()
    launches["flash_attention"] += train["flash_attention"]
    log("train", f"phase wall {time.perf_counter() - t_train:.1f} s")
    t_train = time.perf_counter()
    phase_granite_train()
    log("granite", f"training phase wall {time.perf_counter() - t_train:.1f} s")

    # The audio encoder: hubert-xlarge encoded through the kernels (its
    # launches counted from zero inside) and trained on the plain routes.
    t_path = time.perf_counter()
    for name, n in phase_hubert().items():
        launches[name] += n
    torch.cuda.empty_cache()
    log("hubert", f"phase wall {time.perf_counter() - t_path:.1f} s")

    # qwen3-0.6b served and trained sharded on a one-rank mesh; its
    # attention launches counted from zero inside.
    t_path = time.perf_counter()
    for name, n in phase_sharding().items():
        launches[name] += n
    torch.cuda.empty_cache()
    log("sharding", f"phase wall {time.perf_counter() - t_path:.1f} s")

    # The examples, each kernel counted from zero inside.
    t_path = time.perf_counter()
    for name, n in phase_examples().items():
        launches[name] += n
    torch.cuda.empty_cache()
    log("examples", f"phase wall {time.perf_counter() - t_path:.1f} s")

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
