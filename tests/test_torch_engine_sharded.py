"""The engine-sharded oracle (``EngineOracle(sharded=True)``) and its world
of rank processes (``repro_torch.mapreduce.ranks``), on the CPU.

Every rank is a gloo process of its own.  At W = 1 a traced job's
counters (pairs, bytes, drops; everything but the clock-valued
``cpu_s`` / ``net_s``) equal the reference's ``EngineOracle(sharded=True,
traced=True)`` for the same job: the reference's sharded mode runs only on
a one-device mesh on jax 0.9.0 (ROADMAP.md queue 3 item 2).  At W = 2 and
4 the world's outputs and ``dropped`` equal the port's fused mode with the
emulated all-to-all shuffle bit for bit, and its collected counts equal
the lexsort fused mode's.  The rest is the oracle's and the world's
contract: the scheduler on the elastic cluster, the refusals, a failing
rank, and no process left behind.

Every test that starts ranks takes the session's rank-process lock (the
one ``tests/test_torch_shuffle.py`` takes), and its world's ``file://``
init lies under ``tmp_path``.
"""

import fcntl
import json
import multiprocessing as mp
import os
import signal
import tempfile
import time

import numpy as np
import pytest
import torch

import repro.cluster as rc
import repro_torch.cluster as pc
import repro_torch.launch.cluster as plaunch
from repro_torch.elastic import ElasticCluster
from repro_torch.mapreduce import ExecutionPlan, JobConfig, collect_results
from repro_torch.mapreduce.ranks import RankRequest, RankWorld
from repro_torch.runner import make_app

CLOCKS = ("cpu_s", "net_s")
M, R, SIZE = 5, 3, 2048


def _rank_children():
    return [p for p in mp.active_children() if p.name.startswith("repro-rank")]


@pytest.fixture
def ranks(tmp_path, tmp_path_factory, monkeypatch):
    """The rank-process lock, worlds initialised under ``tmp_path``, and
    no rank process alive after the test."""
    with open(tmp_path_factory.getbasetemp().parent / "gloo_ranks.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
        yield tmp_path
        assert _rank_children() == []


def _fused(app_name, backend, W, combiner, shuffle):
    app, corpus = make_app(app_name, SIZE)
    cfg = JobConfig(M, R, W, combiner=combiner, reduce_backend=backend,
                    shuffle_backend=shuffle)
    return ExecutionPlan(app, cfg, SIZE, device="cpu").fused()(torch.as_tensor(corpus))


@pytest.mark.parametrize("app", ["wordcount", "eximparse"])
def test_w1_trace_counters_equal_reference(app, ranks):
    """One rank: each phase's counters equal the reference's sharded
    traced job's, combiner off and on."""
    with pc.EngineOracle(warmup=0, traced=True, sharded=True, device="cpu") as port:
        assert port.platform == "engine-sharded"
        for combiner in (False, True):
            ref = rc.EngineOracle(warmup=0, traced=True, sharded=True)
            ref.time(app, "jnp", SIZE, 4, 4, 1, combiner=combiner)
            assert port.time(app, "torch", SIZE, 4, 4, 1, combiner=combiner) > 0
            want, got = ref.take_trace(), port.take_trace()
            assert got.phase_names() == want.phase_names()
            for phase in want.phase_names():
                a = {k: v for k, v in want.phase(phase).counters.items() if k not in CLOCKS}
                b = {k: v for k, v in got.phase(phase).counters.items() if k not in CLOCKS}
                assert b == a, (app, combiner, phase)
            assert got.check_conservation() == []
        assert list(ranks.glob("repro_ranks_*"))  # the world's init lies here
    assert not list(ranks.glob("repro_ranks_*"))


@pytest.mark.parametrize("W", [2, 4])
def test_gloo_ranks_equal_fused(W, ranks):
    """W gloo ranks: both apps, combiner off and on, backends ``torch`` and
    ``scatter_reduce``; outputs and ``dropped`` bit for bit against the
    emulated all-to-all, counts against the lexsort fused mode."""
    with RankWorld(W, "cpu", timeout=120) as world:
        for app in ("wordcount", "eximparse"):
            for combiner in (False, True):
                for backend in ("torch", "scatter_reduce"):
                    ctx = (W, app, combiner, backend)
                    reply = world.run(RankRequest(app, SIZE, backend, M, R, combiner=combiner,
                                                  warmup=0, outputs=True))
                    ok, ov, dropped = reply.outputs
                    want = _fused(app, backend, W, combiner, "all_to_all")
                    assert np.array_equal(ok, want[0].numpy()), ctx
                    assert np.array_equal(ov, want[1].numpy()), ctx
                    assert dropped == int(want[2]), ctx
                    lex = _fused(app, backend, W, combiner, "lexsort")
                    assert collect_results(torch.as_tensor(ok), torch.as_tensor(ov)) == \
                        collect_results(lex[0], lex[1]), ctx
                    assert reply.wall_s > 0 and reply.trace is None, ctx
                    assert reply.launches == {"segment_reduce": 0, "local_reduce": 0}, ctx


def test_traced_request_returns_rank0_trace(ranks):
    """A traced request's trace crosses the pipe whole: it conserves and
    its counters describe the W-rank job."""
    with RankWorld(2, "cpu", timeout=120) as world:
        reply = world.run(RankRequest("wordcount", SIZE, "torch", M, R, combiner=True,
                                      traced=True, warmup=1))
    trace = reply.trace
    assert trace.phase_names() == ["map", "combine", "shuffle", "reduce"]
    assert trace.check_conservation() == []
    assert trace.counter("map", "workers") == 2
    assert trace.counter("map", "pairs_emitted") == SIZE
    assert trace.config["num_workers"] == 2


@pytest.mark.parametrize("workers", [1, 2])
def test_elastic_cluster_on_engine_sharded_oracle(workers, ranks):
    """The mirror of the reference's
    ``test_engine_sharded_oracle_per_phase_traces``: fifo-static on an
    ``ElasticCluster`` of 2 workers, every job completed with per-phase
    walls.  The elastic simulator prices a job's wave steps with
    ``remaining_segments``, which steps the one-worker resumable job in
    this process in both modes, as the reference's does."""
    with pc.EngineOracle(warmup=0, size_quantum=1024, traced=True, sharded=True,
                         device="cpu") as oracle:
        jobs = pc.generate_workload(2, seed=1, arrival="uniform", mean_interarrival=0.05,
                                    size_range=(2048, 4096))
        result = ElasticCluster(2, oracle).run(
            jobs, pc.get_policy("fifo-static", mappers=4, reducers=4, workers=workers))
    assert all(r.completed for r in result.records)
    for rec in result.records:
        times = rec.trace.phase_times()
        assert set(times) >= {"map", "shuffle", "reduce"}
        assert all(v > 0 for v in times.values())
        assert rec.trace.check_conservation() == []


def test_untraced_oracle_times_and_profiles_through_ranks(ranks):
    with pc.EngineOracle(warmup=0, sharded=True, device="cpu") as oracle:
        assert oracle.time("wordcount", "torch", SIZE, 4, 4, 2) > 0
        assert oracle.take_trace() is None
        prof = oracle.phase_profile("wordcount", "torch", SIZE, 4, 4, 2, combiner=True)
        assert set(prof["time_s"]) == {"map", "combine", "shuffle", "reduce"}
        assert prof["shuffle_bytes"] > 0
        assert oracle.rank_launches == {"segment_reduce": 0, "local_reduce": 0}
        assert len(_rank_children()) == 2


def test_grant_above_the_devices_raises_before_any_process(ranks):
    too_many = os.cpu_count() + 1
    with pytest.raises(ValueError, match=f"only {os.cpu_count()} CPU devices"):
        RankWorld(too_many, "cpu")
    with pc.EngineOracle(warmup=0, sharded=True, device="cpu") as oracle:
        with pytest.raises(ValueError, match="devices"):
            oracle.time("wordcount", "torch", SIZE, 4, 2, too_many)
    assert _rank_children() == []
    assert not list(ranks.glob("repro_ranks_*"))


def test_pipelined_does_not_compose_with_sharded():
    with pytest.raises(ValueError, match="does not compose with sharded"):
        pc.EngineOracle(sharded=True, pipelined=True, device="cpu")
    with pytest.raises(SystemExit, match="does not compose"):
        plaunch.main(["--device", "cpu", "--oracle", "engine-sharded", "--jobs", "2",
                      "--overlap-depth", "1,2"])


def test_failing_rank_raises_its_traceback(ranks):
    world = RankWorld(2, "cpu", timeout=60)
    with pytest.raises(RuntimeError, match="(?s)rank [01] of 2 failed.*unknown app 'nope'"):
        world.run(RankRequest("nope", SIZE, "torch", M, R))
    assert world.closed and _rank_children() == []


def test_dead_rank_raises_while_its_peer_waits(ranks):
    """Rank 1 is killed; rank 0 blocks in the barrier, and the controller
    raises at once, naming the dead rank, instead of waiting for it."""
    world = RankWorld(2, "cpu", timeout=60)
    world._procs[1].kill()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited with code -9"):
        world.run(RankRequest("wordcount", SIZE, "torch", M, R))
    assert time.monotonic() - t0 < 30
    assert world.closed and _rank_children() == []


def test_silent_rank_raises_within_the_timeout(ranks):
    """Rank 1 is stopped: the request must end, with an error, within the
    world's timeout (the controller's deadline or rank 0's own collective
    timeout, whichever comes first)."""
    world = RankWorld(2, "cpu", timeout=5)
    os.kill(world._procs[1].pid, signal.SIGSTOP)
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        world.run(RankRequest("wordcount", SIZE, "torch", M, R))
    assert time.monotonic() - t0 < 20
    assert world.closed and _rank_children() == []


def test_close_leaves_no_process(ranks):
    world = RankWorld(2, "cpu", timeout=60)
    procs = list(world._procs)
    assert all(p.is_alive() for p in procs)
    world.close()
    world.close()  # idempotent
    assert not any(p.is_alive() for p in procs)
    with pytest.raises(RuntimeError, match="closed"):
        world.run(RankRequest("wordcount", SIZE, "torch", M, R))
    with RankWorld(1, "cpu", timeout=60) as world:
        procs = list(world._procs)
    assert not any(p.is_alive() for p in procs)
    assert not list(ranks.glob("repro_ranks_*"))


def test_cli_engine_sharded_on_cpu(tmp_path, ranks):
    """``--oracle engine-sharded`` end to end on gloo ranks: every job
    completes and carries per-phase spans measured on the sharded path.
    fifo-static grants 4 workers, so the cluster has 4 (with 2 its
    ``prepare`` refuses the grant, in both packages)."""
    out_json, trace = tmp_path / "m.json", tmp_path / "t.json"
    plaunch.main(["--device", "cpu", "--oracle", "engine-sharded", "--jobs", "2",
                  "--workers", "4", "--policies", "fifo-static", "--size-min", "2048",
                  "--size-max", "4096", "--json", str(out_json), "--trace-out", str(trace)])
    assert json.loads(out_json.read_text())["fifo-static"]["n_completed"] == 2
    events = json.loads(trace.read_text())["traceEvents"]
    phases = [e for e in events if e.get("cat") == "phase" and e.get("ph") == "X"]
    assert {e["name"] for e in phases} == {"map", "shuffle", "reduce"}
    assert all(e["args"]["workers"] == 4 for e in phases)
