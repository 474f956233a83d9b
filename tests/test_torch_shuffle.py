"""The port's all-to-all shuffle against the reference's, on the CPU.

The emulated collective (the block transpose between the pack and unpack
halves) in the fused, traced and pipelined modes, held against the
reference's emulated mode at W = 1-4 (W = 3 does not divide M = 5, and
W = 4 is more than R = 3) for every backend pair and the combiner on and
off; a one-key corpus that overflows; ``partition_cap`` and ``meta``; the
sharded mode on a gloo group of one rank against the reference's
``sharded`` on a one-device mesh; and the sharded mode at W = 2 and 4 in
gloo ranks of their own against the port's emulated mode.  Every
comparison is bit for bit (the engine is integer-valued), counters equal
(clock-valued ``cpu_s``, ``net_s`` and ``cpu_workers`` aside).
"""

import dataclasses
import datetime
import fcntl
import functools
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.mapreduce as ref
import repro.telemetry as rtel
import repro_torch.mapreduce as port
import repro_torch.telemetry as ptel
from repro_torch.convert import REFERENCE_BACKEND_NAMES, job_config_from_reference

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
CORPUS = ref.wordcount_corpus(360, vocab_size=53, seed=9)
SKEW = np.zeros(600, dtype=np.int32)  # one key: every pair to one reducer
CLOCKS = ("cpu_s", "net_s", "cpu_workers")
PORT_BACKEND = dict(REFERENCE_BACKEND_NAMES)


def _cfgs(**kw):
    kw.setdefault("num_mappers", 5)
    kw.setdefault("num_reducers", 3)
    kw.setdefault("capacity_factor", 8.0)
    kw.setdefault("shuffle_backend", "all_to_all")
    ref_cfg = ref.JobConfig(**kw)
    return ref_cfg, job_config_from_reference(dataclasses.asdict(ref_cfg))


@functools.lru_cache(maxsize=None)
def _plans(corpus_name="wordcount", **kw):
    """(reference plan, port plan, corpus) for one setting; cached so each
    reference plan compiles once per module."""
    corpus, key_space = (CORPUS, 53) if corpus_name == "wordcount" else (SKEW, 16)
    ref_cfg, port_cfg = _cfgs(**kw)
    return (ref.ExecutionPlan(ref.wordcount(key_space), ref_cfg, len(corpus)),
            port.ExecutionPlan(port.wordcount(key_space), port_cfg, len(corpus),
                               device="cpu"),
            corpus)


@functools.lru_cache(maxsize=None)
def _ref_fused(**kw):
    rplan, _, corpus = _plans(**kw)
    return tuple(np.asarray(a) for a in rplan.fused()(corpus))


@functools.lru_cache(maxsize=None)
def _ref_traced(**kw):
    rplan, _, corpus = _plans(**kw)
    rec = rtel.PhaseRecorder()
    out = rplan.traced(rec)(corpus)
    return tuple(np.asarray(a) for a in out), _counters(rec.last)


def _counters(trace):
    return [(p.phase, {k: v for k, v in p.counters.items() if k not in CLOCKS})
            for p in trace.phases]


def _assert_same(got, want, ctx=None):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, ctx
        np.testing.assert_array_equal(torch.as_tensor(g).numpy(), w, err_msg=str(ctx))


# ------------------------------------------------------------- emulated

@pytest.mark.parametrize("ref_backend", sorted(PORT_BACKEND))
@pytest.mark.parametrize("combiner", [False, True])
@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_emulated_modes_match_reference_fused(ref_backend, combiner, W):
    """fused, traced and pipelined (D = 2) against the reference's fused
    all-to-all job: outputs and ``dropped`` bit for bit."""
    kw = dict(num_workers=W, combiner=combiner, reduce_backend=ref_backend)
    _, pplan, corpus = _plans(**kw)
    want = _ref_fused(**kw)
    _assert_same(pplan.fused()(corpus), want, "fused")
    _assert_same(pplan.traced(ptel.PhaseRecorder())(corpus), want, "traced")
    _assert_same(pplan.pipelined(depth=2)(corpus), want, "pipelined")
    assert want[0].shape == (3, pplan.partition_cap(W))


@pytest.mark.parametrize("combiner", [False, True])
@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_emulated_counters_and_pipelined_match_reference(combiner, W):
    """Every traced counter as the reference counts it (its reduce backends
    count alike), and the pipelined mode against the reference's."""
    kw = dict(num_workers=W, combiner=combiner, reduce_backend="jnp")
    rplan, pplan, corpus = _plans(**kw)
    want, counters = _ref_traced(**kw)
    rec = ptel.PhaseRecorder()
    _assert_same(pplan.traced(rec)(corpus), want)
    assert _counters(rec.last) == counters
    assert rec.last.check_conservation() == []
    _assert_same(pplan.pipelined(depth=2)(corpus), rplan.pipelined(depth=2)(corpus))


@pytest.mark.parametrize("W", [2, 3])
def test_skew_drops_and_counts_like_reference(W):
    """A one-key corpus at capacity factor 1 overflows: ``dropped`` and the
    per-phase counters equal the reference's."""
    kw = dict(corpus_name="skew", num_mappers=2, num_reducers=4, num_workers=W,
              capacity_factor=1.0)
    _, pplan, corpus = _plans(**kw)
    want, counters = _ref_traced(**kw)
    assert int(want[2]) > 0
    rec = ptel.PhaseRecorder()
    _assert_same(pplan.traced(rec)(corpus), want)
    assert _counters(rec.last) == counters
    _assert_same(pplan.fused()(corpus), _ref_fused(**kw))


@pytest.mark.parametrize("M,R,W", [(5, 3, 2), (7, 5, 3), (3, 2, 4), (20, 5, 1),
                                   (37, 40, 4)])
@pytest.mark.parametrize("combiner", [False, True])
def test_partition_cap_and_meta_match_reference(M, R, W, combiner):
    rplan, pplan, _ = _plans(num_mappers=M, num_reducers=R, num_workers=W,
                             combiner=combiner)
    for workers in (None, 1, 2, 3, 4, M + 1):
        assert pplan.partition_cap(workers) == rplan.partition_cap(workers), workers
        assert pplan.meta(workers) == rplan.meta(workers), workers


def test_shuffle_stepper_cache_keys_follow_reference():
    """The collective's stepper is per grant; the cache counts match."""
    rplan, pplan, _ = _plans(num_workers=2)
    for plan in (rplan, pplan):
        for W in (2, 3, 2, 1):
            plan.shuffle_stepper(W)
    assert pplan.cache_info() == rplan.cache_info()


def test_pack_keeps_equal_keys_in_input_order():
    """Duplicate keys reach their bucket in input order (their values
    differ), as ``jnp.lexsort`` leaves them."""
    rplan, pplan, _ = _plans(num_workers=2)
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 6, (2, 40)).astype(np.int32)
    vals = np.arange(80, dtype=np.int32).reshape(2, 40)
    valid = rng.random((2, 40)) < 0.8
    cfg = dataclasses.replace(pplan.cfg, num_workers=2)
    rcfg = dataclasses.replace(rplan.cfg, num_workers=2)
    send, dropped = pplan.shuffle.pack(cfg, *map(torch.from_numpy, (keys, vals, valid)))
    for b in range(2):
        rsend, rdropped = rplan.shuffle.pack(rcfg, keys[b], vals[b], valid[b])
        _assert_same([s[b] for s in send], rsend, b)
        assert int(dropped[b]) == int(rdropped)


# --------------------------------------------------------------- sharded

@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo process group of one rank in this process (file:// init, so
    parallel test workers cannot collide on a port)."""
    path = tmp_path_factory.mktemp("pg") / "init"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("ref_backend", ["jnp", "pallas"])
@pytest.mark.parametrize("combiner", [False, True])
def test_sharded_w1_matches_reference_sharded(world1, ref_backend, combiner):
    """W = 1 on gloo against ``sharded(jax.make_mesh((1,), ("workers",)))``:
    the fused form with ``counters=True`` and the traced form."""
    kw = dict(num_workers=1, combiner=combiner, reduce_backend=ref_backend)
    rplan, pplan, corpus = _plans(**kw)
    mesh = jax.make_mesh((1,), ("workers",))
    rok, rov, rdropped, rstats = rplan.sharded(mesh, counters=True)(corpus)
    ok, ov, dropped, stats = pplan.sharded(world1, counters=True)(corpus)
    _assert_same((ok, ov, dropped), (rok, rov, rdropped))
    np.testing.assert_array_equal(stats["dropped_per_worker"],
                                  rstats["dropped_per_worker"])
    assert (stats["dropped_send"], stats["dropped_recv"]) == \
        (rstats["dropped_send"], rstats["dropped_recv"])
    _assert_same((ok, ov, dropped), _ref_fused(**kw))

    rrec, prec = rtel.PhaseRecorder(), ptel.PhaseRecorder()
    rout = rplan.sharded(mesh, recorder=rrec)(corpus)
    _assert_same(pplan.sharded(recorder=prec)(corpus), rout)
    assert _counters(prec.last) == _counters(rrec.last)
    assert prec.last.check_conservation() == []


def test_sharded_w1_skew_counters_match_reference(world1):
    """Overflow under skew: the traced form with ``counters=True``, the
    per-worker stats and the shuffle's send / recv drops."""
    kw = dict(corpus_name="skew", num_mappers=2, num_reducers=4, num_workers=1,
              capacity_factor=1.0)
    rplan, pplan, corpus = _plans(**kw)
    rrec, prec = rtel.PhaseRecorder(), ptel.PhaseRecorder()
    mesh = jax.make_mesh((1,), ("workers",))
    rok, rov, rdropped, rstats = rplan.sharded(mesh, counters=True, recorder=rrec)(corpus)
    ok, ov, dropped, stats = pplan.sharded(counters=True, recorder=prec)(corpus)
    assert int(dropped) > 0
    _assert_same((ok, ov, dropped), (rok, rov, rdropped))
    np.testing.assert_array_equal(stats["dropped_per_worker"], rstats["dropped_per_worker"])
    assert _counters(prec.last) == _counters(rrec.last)


def test_sharded_refuses_a_group_of_another_size(world1):
    _, pplan, _ = _plans(num_workers=2)
    with pytest.raises(ValueError, match="process group size 1"):
        pplan.sharded(world1)


_RANK_SCRIPT = r"""
import datetime, sys, time
import torch
import torch.distributed as dist

sys.path.insert(0, sys.argv[3])
import repro_torch.mapreduce as port
from repro_torch.telemetry import PhaseRecorder

t0 = time.perf_counter()
rank, init = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=4,
                        timeout=datetime.timedelta(seconds=60))
# Every rank takes part in making both pairs; then ranks 0-1 and 2-3 run
# the W = 2 cases at once, each pair on its own group (on 2-3 the group's
# rank is not the global one), and all four run the W = 4 cases together.
pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
corpus = port.wordcount_corpus(900, vocab_size=53, seed=9)
skew = torch.zeros(600, dtype=torch.int32)
cases = 0
for W, group in ((2, pairs[rank // 2]), (4, None)):
    for corpus_, app, f in ((corpus, port.wordcount(53), 8.0),
                            (skew, port.wordcount(16), 1.0)):
        for combiner in (False, True):
            for backend in ("torch", "cuda"):
                cfg = port.JobConfig(5, 3, W, capacity_factor=f, combiner=combiner,
                                     reduce_backend=backend, shuffle_backend="all_to_all")
                plan = port.ExecutionPlan(app, cfg, len(corpus_), device="cpu")
                want = plan.fused()(corpus_)
                ok, ov, dropped, stats = plan.sharded(group, counters=True)(corpus_)
                ctx = (W, f, combiner, backend)
                assert all(torch.equal(a, b) for a, b in zip((ok, ov, dropped), want)), ctx
                assert stats["dropped_per_worker"].shape == (W, 2), ctx
                assert stats["dropped_send"] + stats["dropped_recv"] == int(dropped), ctx
                assert (f == 1.0 and not combiner) == (int(dropped) > 0), ctx
                rec = PhaseRecorder()
                traced = plan.sharded(group, recorder=rec)(corpus_)
                assert all(torch.equal(a, b) for a, b in zip(traced, want)), ctx
                assert (bad := rec.last.check_conservation()) == [], (ctx, bad)
                assert rec.last.counter("shuffle", "pairs_dropped") == int(dropped), ctx
                cases += 1
dist.barrier()
dist.destroy_process_group()
print(f"rank {rank}: {cases} cases in {time.perf_counter() - t0:.1f} s", flush=True)
"""


@pytest.fixture
def rank_processes_alone(tmp_path_factory):
    """A lock shared by the test workers of one session (their base
    directory's parent), held by every test that starts gloo rank
    processes, so no two such tests' ranks compete for the cores."""
    with open(tmp_path_factory.getbasetemp().parent / "gloo_ranks.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def run_ranks(argvs, env, timeout=240) -> list[str]:
    """Start one process per argv together; each rank's merged output.
    Fails with every rank's output if one is still running after
    ``timeout`` seconds."""
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs += [p.communicate()[0] for p in procs[len(outs):]]
        pytest.fail(f"rank processes still running after {timeout} s:\n" + "\n".join(outs))
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    return outs


def test_sharded_w2_w4_gloo_ranks_match_emulated(tmp_path, rank_processes_alone):
    """Four gloo ranks, each its own process (CPU tensors), every rank
    running the same cases in step: W = 2 on the groups of ranks 0-1 and
    2-3 at once, then W = 4 on the world; both corpora (the one-key one
    overflows), combiner on and off, both reduce backends, fused, sharded
    and traced, against the port's emulated mode at the same W, outputs
    and ``dropped`` bit for bit."""
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    init = f"file://{tmp_path / 'pg'}"
    outs = run_ranks([[sys.executable, str(script), str(r), init, str(SRC)] for r in range(4)],
                     {**os.environ, "OMP_NUM_THREADS": "1"})
    for r, out in enumerate(outs):
        assert f"rank {r}: 16 cases" in out, out


_LATE_RANK_SCRIPT = r"""
import datetime, sys, time
import torch.distributed as dist

sys.path.insert(0, sys.argv[3])
import repro_torch.mapreduce as port
from repro_torch.telemetry import PhaseRecorder

rank, init = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
corpus = port.wordcount_corpus(900, vocab_size=53, seed=9)
cfg = port.JobConfig(5, 3, 2, combiner=True, shuffle_backend="all_to_all")
plan = port.ExecutionPlan(port.wordcount(53), cfg, len(corpus), device="cpu")
want = plan.fused()(corpus)
job = plan.sharded(recorder=(rec := PhaseRecorder()))
job(corpus)  # a first traced call in step: both ranks warm
dist.barrier()
if rank == 1:
    time.sleep(0.5)  # late: rank 0 waits for it in the map's counter sum
out = job(corpus)
assert all(a.equal(b) for a, b in zip(out, want))
bad = rec.last.check_conservation()
map_s = rec.last.phases[0].wall_s
dist.barrier()
dist.destroy_process_group()
print(f"rank {rank}: map {map_s:.3f} s, total {rec.last.total_s:.3f} s, "
      f"violations {bad}", flush=True)
assert bad == [], bad
if rank == 0:
    assert map_s >= 0.4, map_s
"""


def test_sharded_traced_phase_waits_for_a_late_rank(tmp_path, rank_processes_alone):
    """Two gloo ranks at W = 2; rank 1 starts its traced call 0.5 s late.
    Rank 0 waits for it in the map's cross-rank counter sum, and that wait
    must fall inside the map phase (as the reference's
    ``block_until_ready`` on a sharded array puts it), so every rank's
    trace conserves: the phase walls sum to the job's total."""
    script = tmp_path / "late_rank.py"
    script.write_text(_LATE_RANK_SCRIPT)
    init = f"file://{tmp_path / 'pg'}"
    outs = run_ranks([[sys.executable, str(script), str(r), init, str(SRC)] for r in range(2)],
                     {**os.environ, "OMP_NUM_THREADS": "1"}, timeout=120)
    for r, out in enumerate(outs):
        assert f"rank {r}: map" in out and "violations []" in out, out
