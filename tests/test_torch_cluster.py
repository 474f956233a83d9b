"""The port's cluster layer (``repro_torch.cluster``, ``elastic.sim``,
``launch.cluster``) against the reference's, on the CPU.

Seeded ``AnalyticOracle`` traces run through ``Cluster`` and
``ElasticCluster`` under every registered policy in both packages, and
``TraceResult.metrics()`` must be equal, key for key, with the reduce
backends renamed (``convert.REFERENCE_BACKEND_NAMES``).  That is exact in
two ways: on a model database fitted by the reference and carried across
(``convert.model_database_from_reference``), and with each package
bootstrapping its own.  The second holds because the scheduler's fits
solve in numpy float64 on float32 design matrices whose entries agree to
the bit; the fitted predictions are also held at the core's tolerance
(rtol 1e-4, atol 1e-6, ``tests/test_torch_core.py``), since a float32 fit
could flip a plan at a near-tie, and this file would then say so by
failing its exact check, not by re-seeding.

The engine oracle runs tiny jobs (2048 tokens) on the CPU, as
``tests/test_cluster.py`` runs the reference's.
"""

import dataclasses
import json

import numpy as np
import pytest

import repro.cluster as rc
import repro.launch.cluster as rlaunch
import repro_torch.cluster as pc
import repro_torch.launch.cluster as plaunch
from repro.cluster.policies import _np_predict as ref_np_predict
from repro.core.predictor import ModelDatabase as RefModelDatabase
from repro.elastic import ElasticCluster as RefElasticCluster
from repro_torch.cluster.policies import _np_predict, _parse_cat
from repro_torch.convert import (
    REFERENCE_BACKEND_NAMES,
    model_database_from_reference,
    model_database_to_reference,
)
from repro_torch.core.predictor import ModelDatabase
from repro_torch.elastic import ElasticCluster, Regrant

APPS = ["wordcount", "eximparse"]
FAST = dict(mapper_grid=(4, 8, 16), reducer_grid=(4, 8, 16),
            worker_grid=(2, 4), bootstrap_sizes=(1 << 13, 1 << 15, 1 << 17))
POLICY_NAMES = sorted(pc.POLICIES)


def _workload(pkg, oracle):
    """A contended trace: bursty arrivals, half the jobs with tight
    deadlines (``predict-elastic`` regrants on it)."""
    jobs = pkg.generate_workload(
        30, seed=1, arrival="bursty", mean_interarrival=0.08,
        size_range=(1 << 14, 1 << 18),
    )
    return pkg.assign_deadlines(
        jobs, lambda j: oracle.nominal_time(j.app, j.size),
        slack_range=(1.1, 2.2), fraction=0.5, seed=2,
    )


def _policy(pkg, name, **kw):
    if name == "fifo-static":
        backend = "jnp" if pkg is rc else "torch"
        return pkg.get_policy(name, workers=4, backend=backend)
    return pkg.get_policy(name, seed=0, **FAST, **kw)


def _run(pkg, name, elastic, **kw):
    oracle = pkg.AnalyticOracle(noise=0.02, seed=3)
    jobs = _workload(pkg, oracle)
    ec = RefElasticCluster if pkg is rc else ElasticCluster
    cluster = ec(12, oracle) if elastic else pkg.Cluster(12, oracle)
    policy = _policy(pkg, name, **kw)
    return cluster.run(jobs, policy), policy


def _plans(result, rename):
    return [
        (r.spec.job_id, r.admitted, r.start, r.finish, r.n_regrants,
         None if r.plan is None else dict(
             dataclasses.asdict(r.plan),
             backend=rename.get(r.plan.backend, r.plan.backend)))
        for r in result.records
    ]


def _same_run(ref_result, port_result):
    assert port_result.metrics() == ref_result.metrics()
    assert _plans(port_result, {}) == _plans(ref_result,
                                             REFERENCE_BACKEND_NAMES)


# ---------------------------------------------------------------------------
# Workload and analytic oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arrival", ["poisson", "uniform", "bursty"])
def test_workload_equals_reference(arrival):
    kw = dict(seed=4, arrival=arrival, mean_interarrival=0.3,
              size_range=(1 << 12, 1 << 20))
    ref_jobs = rc.generate_workload(40, **kw)
    est = lambda j: j.size * 1e-5  # noqa: E731
    ref_jobs = rc.assign_deadlines(ref_jobs, est, fraction=0.5, seed=1)
    port_jobs = pc.assign_deadlines(pc.generate_workload(40, **kw), est,
                                    fraction=0.5, seed=1)
    assert [dataclasses.asdict(j) for j in port_jobs] == \
        [dataclasses.asdict(j) for j in ref_jobs]


@pytest.mark.parametrize("ref_backend", ["jnp", "xla", "pallas"])
@pytest.mark.parametrize("combiner", [False, True])
def test_analytic_oracle_equals_reference(ref_backend, combiner):
    backend = REFERENCE_BACKEND_NAMES[ref_backend]
    ro = rc.AnalyticOracle(noise=0.05, seed=3, shift_after_job=5,
                           shift_factor=1.5)
    po = pc.AnalyticOracle(noise=0.05, seed=3, shift_after_job=5,
                           shift_factor=1.5)
    assert po.backends() == tuple(REFERENCE_BACKEND_NAMES[b]
                                  for b in ro.backends())
    for app in APPS:
        for job_id, depth in ((0, 1), (7, 2), (rc.oracle.PROFILE_JOB_ID, 3)):
            args = (app, 1 << 16, 8, 12, 4)
            kw = dict(job_id=job_id, depth=depth, combiner=combiner)
            assert po.time(args[0], backend, *args[1:], **kw) == \
                ro.time(args[0], ref_backend, *args[1:], **kw)
            pt, rt = po.take_trace(), ro.take_trace()
            assert pt.to_dict()["phases"] == rt.to_dict()["phases"]
            assert pt.check_conservation() == []
        part = dict(map_tasks_done=3, job_id=9, combiner=combiner)
        assert po.remaining_segments(app, backend, 1 << 16, 8, 12, 4,
                                     **part) == \
            ro.remaining_segments(app, ref_backend, 1 << 16, 8, 12, 4, **part)
        assert po.phase_profile(app, backend, 1 << 15, 8, 8, 4, combiner) == \
            ro.phase_profile(app, ref_backend, 1 << 15, 8, 8, 4, combiner)
        assert po.nominal_time(app, 1 << 16) == ro.nominal_time(app, 1 << 16)


# ---------------------------------------------------------------------------
# Every policy on both simulators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("elastic", [False, True], ids=["cluster", "elastic"])
@pytest.mark.parametrize("name", POLICY_NAMES)
def test_policy_run_equals_reference(name, elastic):
    """Each package bootstraps its own models from its own oracle."""
    ref_result, ref_policy = _run(rc, name, elastic)
    port_result, port_policy = _run(pc, name, elastic)
    _same_run(ref_result, port_result)
    if name == "predict-elastic" and elastic:
        assert port_result.metrics()["n_regrants"] > 0


def test_fifo_static_defaults_to_torch():
    policy = pc.StaticFIFO()
    assert policy._plan.backend == "torch"


@pytest.mark.parametrize("name", ["predict-sjf", "predict-combine",
                                  "predict-resource", "predict-elastic"])
def test_bootstrap_fits_match_reference(name):
    """A bootstrap inside the port fits the reference's models: each
    category's predictions at the core's tolerance."""
    cluster_r = rc.Cluster(12, rc.AnalyticOracle(noise=0.02, seed=3))
    cluster_p = pc.Cluster(12, pc.AnalyticOracle(noise=0.02, seed=3))
    ref_policy, port_policy = _policy(rc, name), _policy(pc, name)
    ref_policy.prepare(cluster_r, APPS)
    port_policy.prepare(cluster_p, APPS)
    assert len(port_policy.db) == len(ref_policy.db) > 0
    rows = np.asarray([(m, r, w, s / 1024.0) for m in (4, 6, 16)
                       for r in (4, 9, 16) for w in (2, 4)
                       for s in (1 << 13, 1 << 16, 1 << 17)])
    for key in ref_policy.db.applications():
        app, plat, cat = key[:3]
        res = key[3] if len(key) > 3 else ""
        backend, depth, comb = _parse_cat(cat)
        port_cat = cat.replace(backend, REFERENCE_BACKEND_NAMES[backend], 1)
        want = ref_np_predict(ref_policy.db.get(app, plat, cat, res), rows)
        got = _np_predict(port_policy.db.get(app, plat, port_cat, res), rows)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("elastic", [False, True], ids=["cluster", "elastic"])
@pytest.mark.parametrize("name", ["predict-sjf", "predict-combine",
                                  "predict-deadline", "predict-elastic"])
def test_carried_model_database_runs_equal(name, elastic, tmp_path):
    """A database the reference fitted, carried across, warm-starts the
    port's policy (no bootstrap) to the reference's schedule."""
    oracle = rc.AnalyticOracle(noise=0.02, seed=3)
    ref_policy = _policy(rc, name)
    ref_policy.prepare(rc.Cluster(12, oracle), APPS)
    ref_path, port_path = tmp_path / "ref.json", tmp_path / "port.json"
    ref_policy.db.save(str(ref_path))
    port_path.write_text(json.dumps(
        model_database_from_reference(json.loads(ref_path.read_text()))))
    ref_result, _ = _run(rc, name, elastic,
                         db=RefModelDatabase.load(str(ref_path)))
    port_db = ModelDatabase.load(str(port_path))
    port_result, port_policy = _run(pc, name, elastic, db=port_db)
    assert port_policy.refiner._seed == {}  # warm start: nothing profiled
    _same_run(ref_result, port_result)


def test_model_database_conversion_round_trip():
    db = {
        "wordcount\x00sim-analytic-v1\x00jnp": {"coef": [1.0]},
        "wordcount\x00sim-analytic-v1\x00xla@d2+c": {"coef": [2.0]},
        "eximparse\x00engine-wallclock\x00pallas+c\x00shuffle:bytes":
            {"coef": [3.0]},
        "eximparse\x00plat": {"coef": [4.0]},
    }
    port = model_database_from_reference(db)
    assert sorted(k.split("\x00")[2] for k in port if k.count("\x00") > 1) \
        == ["cuda+c", "scatter_reduce@d2+c", "torch"]
    assert model_database_to_reference(port) == db
    with pytest.raises(ValueError, match="unknown reduce backend"):
        model_database_from_reference({"a\x00p\x00mystery": {}})


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

#: keys of the CLI's ``--json`` that hold host wall-clock time: none on the
#: analytic oracle, whose every time is simulated (``TraceResult.metrics``
#: reads only record times), so the whole document is compared.
HOST_CLOCK_KEYS = ()

CLI_ARGS = {
    "base": ["--jobs", "20", "--workers", "8",
             "--policies", "fifo-static,predict-sjf,predict-combine"],
    "elastic": ["--jobs", "24", "--workers", "8", "--elastic",
                "--policies", "predict-deadline,predict-elastic",
                "--arrival", "bursty", "--mean-interarrival", "0.05"],
    "service": ["--service", "--until-jobs", "40", "--workers", "8",
                "--policies", "predict-sjf", "--admission", "burn,static"],
}


def _cli_json(mod, args, path, extra=()):
    argv = ["--oracle", "analytic", *args, *extra, "--json", str(path)]
    if mod is plaunch:
        argv = ["--device", "cpu", *argv]
    mod.main(argv)
    doc = json.loads(path.read_text())
    for m in doc.values():
        for k in HOST_CLOCK_KEYS:
            m.pop(k, None)
    return doc


@pytest.mark.parametrize("case", sorted(CLI_ARGS))
def test_cli_json_equals_reference(case, tmp_path, capsys):
    ref = _cli_json(rlaunch, CLI_ARGS[case], tmp_path / "ref.json")
    port = _cli_json(plaunch, CLI_ARGS[case], tmp_path / "port.json")
    assert port == ref
    out = capsys.readouterr().out
    if case == "base":
        assert "predict-combine" in out


def test_cli_loads_models_the_reference_saved(tmp_path):
    saved = tmp_path / "ref_models.json"
    args = ["--jobs", "16", "--workers", "8", "--policies", "predict-sjf"]
    ref = _cli_json(rlaunch, args, tmp_path / "a.json",
                    ["--save-models", str(saved)])
    carried = tmp_path / "port_models.json"
    carried.write_text(json.dumps(
        model_database_from_reference(json.loads(saved.read_text()))))
    ref_warm = _cli_json(rlaunch, args, tmp_path / "b.json",
                         ["--load-models", str(saved)])
    port_warm = _cli_json(plaunch, args, tmp_path / "c.json",
                          ["--load-models", str(carried)])
    assert port_warm == ref_warm
    assert ref_warm["predict-sjf"]["n_completed"] == \
        ref["predict-sjf"]["n_completed"]


def test_cli_engine_traced_on_cpu(tmp_path):
    """The live engine through the CLI, with its span trace: tiny jobs."""
    out_json, trace = tmp_path / "m.json", tmp_path / "t.json"
    plaunch.main(["--device", "cpu", "--oracle", "engine-traced",
                  "--jobs", "3", "--workers", "4",
                  "--policies", "fifo-static", "--size-min", "2048",
                  "--size-max", "4096", "--json", str(out_json),
                  "--trace-out", str(trace)])
    assert json.loads(out_json.read_text())["fifo-static"]["n_completed"] \
        == 3
    events = json.loads(trace.read_text())["traceEvents"]
    jobs = {e["args"]["job_id"] for e in events
            if e.get("cat") == "job" and e.get("ph") == "X"}
    assert jobs == {0, 1, 2}


# ---------------------------------------------------------------------------
# The engine oracle on the CPU
# ---------------------------------------------------------------------------


def test_engine_oracle_traced_jobs_conserve():
    oracle = pc.EngineOracle(traced=True, device="cpu")
    assert oracle.backends() == ("torch", "scatter_reduce")
    jobs = [pc.JobSpec(job_id=0, app="wordcount", size=2048, arrival=0.0),
            pc.JobSpec(job_id=1, app="eximparse", size=2048, arrival=0.0)]
    res = pc.Cluster(4, oracle).run(
        jobs, pc.get_policy("fifo-static", mappers=4, reducers=4,
                            workers=2, backend="cuda"))
    assert res.metrics()["n_completed"] == 2
    for r in res.records:
        assert r.true_time > 0
        assert r.trace.phase_names() == ["map", "shuffle", "reduce"]
        assert r.trace.config["reduce_backend"] == "cuda"
        assert r.trace.check_conservation() == []


def test_engine_oracle_combiner_trace_has_its_phases():
    oracle = pc.EngineOracle(traced=True, device="cpu")
    oracle.time("wordcount", "cuda", 2048, 4, 3, 2, combiner=True)
    trace = oracle.take_trace()
    assert trace.phase_names() == ["map", "combine", "shuffle", "reduce"]
    assert trace.check_conservation() == []


def test_engine_oracle_untraced_phase_profile_keeps_time_untraced():
    oracle = pc.EngineOracle(device="cpu")
    prof = oracle.phase_profile("wordcount", "torch", 2048, 4, 4, 2)
    assert set(prof["time_s"]) == {"map", "shuffle", "reduce"}
    assert prof["shuffle_bytes"] > 0
    oracle.time("wordcount", "torch", 2048, 4, 4, 2)
    assert oracle.take_trace() is None


@pytest.mark.parametrize("cursor", [
    dict(map_tasks_done=2),
    dict(combiner=True, shuffled=True, reduce_tasks_done=2),
], ids=["mid-map", "combiner-mid-reduce"])
def test_engine_oracle_partial_execution_shapes_match_reference(cursor):
    ref = rc.EngineOracle()
    port = pc.EngineOracle(device="cpu")
    want = ref.remaining_segments("wordcount", "jnp", 2048, 4, 4, 2,
                                  **cursor)
    got = port.remaining_segments("wordcount", "torch", 2048, 4, 4, 2,
                                  **cursor)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert all(t > 0 for _, t in got)
    kw = {k: v for k, v in cursor.items() if k != "combined"}
    for shuffled in (False, True):
        kw["shuffled"] = shuffled
        save_s, restore_s = port.regrant_overhead(
            "wordcount", "torch", 2048, 4, 4, **kw)
        assert isinstance(save_s, float) and isinstance(restore_s, float)
        assert save_s > 0 and restore_s > 0
        # cached per (job, phase of life), as the reference's
        assert port.regrant_overhead("wordcount", "torch", 2048, 4, 4,
                                     **kw) == (save_s, restore_s)


class _ShrinkOnce(pc.SchedulingPolicy):
    """Dispatches every job at two workers; shrinks job 0 to one worker
    once, at its first chance."""

    name = "scripted-shrink"

    def __init__(self):
        self.overheads = []

    def prepare(self, cluster, apps):
        self.cluster = cluster
        self.shrunk = False

    def observe_overhead(self, save_s, restore_s):
        self.overheads.append((save_s, restore_s))

    def select(self, queue, free, now):
        v = {u.job_id: u for u in self.cluster.running_jobs(now)}.get(0)
        if not self.shrunk and v is not None and v.steps_remaining >= 2 \
                and v.pending_workers is None:
            self.shrunk = True
            return Regrant(0, 1, reason="scripted shrink")
        if queue and free >= 2:
            return pc.Dispatch(queue[0], pc.Plan(
                backend="torch", mappers=4, reducers=4, workers=2))
        return None


def test_elastic_cluster_charges_measured_overheads():
    """On the live engine a regrant is charged the oracle's measured
    snapshot walls, never the configured ones, and the policy sees them."""
    oracle = pc.EngineOracle(device="cpu")
    cluster = ElasticCluster(4, oracle, snapshot_overhead_s=99.0,
                             restore_overhead_s=99.0)
    jobs = [pc.JobSpec(job_id=i, app="wordcount", size=2048, arrival=0.0)
            for i in range(2)]
    policy = _ShrinkOnce()
    res = cluster.run(jobs, policy)
    m = res.metrics()
    assert m["n_completed"] == 2 and m["n_regrants"] == 1
    (save_s, restore_s), = policy.overheads
    assert 0 < save_s < 1 and 0 < restore_s < 1
    assert res.records[0].overhead_s == pytest.approx(save_s + restore_s)
    assert res.records[0].trace.check_conservation(
        time_rel_tol=1e-9, time_abs_tol=1e-9) == []
