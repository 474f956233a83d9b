"""The port's observability layer (``repro_torch.obs``) and arrival streams
against the reference's, on the CPU.

Identical seeded runs go through both packages' simulators; what the obs
layer makes of them must be equal: ``JobStream`` arrival sequences, the
``SpanRecorder``'s Perfetto JSON, ``ClusterMetrics``' Prometheus text and
summaries, the resource timeline, the drift ledger, the SLO monitor's
alarms and the overload controller's audit log.  Where a record names a
reduce backend the reference's name is mapped to the port's
(``convert.REFERENCE_BACKEND_NAMES``).  The drift ledger keys its state by
category and sorts by it (``obs/drift.py``), and the port's names sort
differently, so ledger snapshots are compared as dicts.
"""

import dataclasses
import io
import json

import numpy as np
import pytest

import repro.cluster as rc
import repro.obs as ro
import repro_torch.cluster as pc
import repro_torch.obs as po
from repro.elastic import ElasticCluster as RefElasticCluster
from repro_torch.convert import REFERENCE_BACKEND_NAMES
from repro_torch.elastic import ElasticCluster

PKGS = {"ref": (rc, ro, RefElasticCluster), "port": (pc, po, ElasticCluster)}


def _rename(doc):
    """``doc`` with every reference backend name renamed, in the values of
    ``backend`` / ``reduce_backend`` keys and in ``app/category`` keys."""
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if k in ("backend", "reduce_backend", "category") and \
                    isinstance(v, str):
                v = _rename_cat(v)
            else:
                v = _rename(v)
            if isinstance(k, str) and "/" in k:
                app, _, cat = k.partition("/")
                k = f"{app}/{_rename_cat(cat)}"
            out[k] = v
        return out
    if isinstance(doc, list):
        return [_rename(x) for x in doc]
    return doc


def _rename_cat(cat: str) -> str:
    base, sep, rest = cat.partition("@")
    plus = ""
    if not sep and base.endswith("+c"):
        base, plus = base[:-2], "+c"
    return REFERENCE_BACKEND_NAMES.get(base, base) + plus + sep + rest


# ---------------------------------------------------------------------------
# Arrival streams
# ---------------------------------------------------------------------------


def _stream(pkg, kind):
    if kind == "bursty":
        process = pkg.RenewalProcess("bursty", mean_interarrival=0.5, seed=4)
    elif kind == "merged":
        process = pkg.merge_processes(
            pkg.PoissonProcess(1.5, seed=3),
            pkg.RenewalProcess("uniform", mean_interarrival=0.7, seed=5))
    else:
        rate = pkg.diurnal_rate(0.85, amplitude=0.3, period_s=600.0)
        peak = 0.85 * 1.3
        if kind == "flash":
            rate = pkg.flash_crowd_rate(rate, [(120.0, 200.0, 4.5)])
            peak *= 4.5
        process = pkg.PoissonProcess(rate, peak_rate=peak, seed=11)
    oracle = pkg.AnalyticOracle(noise=0.0)
    return pkg.JobStream(
        process, seed=9, deadline_fraction=0.5,
        service_estimate=lambda j: oracle.nominal_time(j.app, j.size),
    )


@pytest.mark.parametrize("kind", ["diurnal", "flash", "bursty", "merged"])
def test_job_stream_equals_reference(kind):
    want = [dataclasses.asdict(j) for j in rc.take(_stream(rc, kind), 120)]
    got = [dataclasses.asdict(j) for j in pc.take(_stream(pc, kind), 120)]
    assert got == want


# ---------------------------------------------------------------------------
# Spans, metrics, resources
# ---------------------------------------------------------------------------


def _base_run(which):
    cl, obs, _ = PKGS[which]
    oracle = cl.AnalyticOracle(noise=0.02, seed=5)
    jobs = cl.generate_workload(15, seed=5, mean_interarrival=0.1,
                                size_range=(1 << 14, 1 << 17))
    cluster = cl.Cluster(8, oracle, net_capacity=4e6)
    cluster.metrics = obs.ClusterMetrics(window_s=5.0)
    policy = cl.get_policy("predict-resource", seed=5, net_capacity=4e6,
                           mapper_grid=(4, 8, 16), reducer_grid=(4, 8, 16),
                           worker_grid=(2, 4),
                           bootstrap_sizes=(1 << 13, 1 << 15, 1 << 17))
    return cluster.run(jobs, policy), cluster.metrics


def _elastic_suspend_run(which):
    cl, obs, ec = PKGS[which]
    oracle = cl.AnalyticOracle(noise=0.02, seed=7)
    jobs = cl.generate_workload(30, seed=7, arrival="bursty",
                                mean_interarrival=0.08,
                                size_range=(1 << 14, 1 << 18))
    jobs = cl.assign_deadlines(
        jobs, lambda j: oracle.nominal_time(j.app, j.size),
        slack_range=(1.1, 2.2), fraction=0.5, seed=8)
    cluster = ec(8, oracle, snapshot_overhead_s=0.02,
                 restore_overhead_s=0.02)
    cluster.metrics = obs.ClusterMetrics()
    policy = cl.get_policy("predict-elastic", seed=7, suspend=True,
                           worker_grid=(2, 4, 8),
                           bootstrap_sizes=(1 << 13, 1 << 15, 1 << 17))
    return cluster.run(jobs, policy), cluster.metrics


RUNS = {"contended-fabric": _base_run, "elastic-suspend": _elastic_suspend_run}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_spans_metrics_resources_equal_reference(run):
    (ref_result, ref_metrics), (port_result, port_metrics) = (
        RUNS[run]("ref"), RUNS[run]("port"))
    assert port_result.metrics() == ref_result.metrics()
    if run == "elastic-suspend":
        assert port_result.metrics()["n_suspends"] > 0
    else:
        assert port_result.metrics()["n_contended_jobs"] > 0

    ref_rec, port_rec = ro.SpanRecorder(), po.SpanRecorder()
    ref_rec.record(ref_result)
    port_rec.record(port_result)
    assert port_rec.check() == ref_rec.check() == []
    want = _rename(json.loads(json.dumps(ref_rec.chrome(), sort_keys=True)))
    got = json.loads(json.dumps(port_rec.chrome(), sort_keys=True))
    assert got == want
    assert po.validate_chrome_trace(got) == []
    assert po.render_slots(port_result) == ro.render_slots(ref_result)

    assert port_metrics.registry.to_prom_text() == \
        ref_metrics.registry.to_prom_text()
    assert port_metrics.summary() == ref_metrics.summary()
    assert port_metrics.to_dict() == ref_metrics.to_dict()

    ref_tl = ro.ResourceTimeline.from_result(ref_result)
    port_tl = po.ResourceTimeline.from_result(port_result)
    assert port_tl.summary() == ref_tl.summary()


def test_span_recorder_ring_and_save(tmp_path):
    results = {w: _base_run(w)[0] for w in PKGS}
    recs = {"ref": ro.SpanRecorder(max_jobs=6),
            "port": po.SpanRecorder(max_jobs=6)}
    for w, rec in recs.items():
        rec.record(results[w])
        rec.save_chrome(str(tmp_path / f"{w}.json"))
    want = _rename(json.loads((tmp_path / "ref.json").read_text()))
    assert json.loads((tmp_path / "port.json").read_text()) == want
    assert len(recs["port"]) == len(recs["ref"])


# ---------------------------------------------------------------------------
# Drift ledger
# ---------------------------------------------------------------------------


def _drift_run(which):
    cl, obs, _ = PKGS[which]
    oracle = cl.AnalyticOracle(noise=0.02, seed=7, shift_after_job=20,
                               shift_factor=2.0)
    jobs = cl.generate_workload(60, seed=7, mean_interarrival=0.3,
                                size_range=(1 << 14, 1 << 16))
    ledger = obs.PredictionLedger()
    policy = cl.get_policy("predict-sjf", seed=7, ledger=ledger,
                           mapper_grid=(4, 8, 16), reducer_grid=(4, 8, 16),
                           worker_grid=(2, 4),
                           bootstrap_sizes=(1 << 13, 1 << 15, 1 << 17))
    result = cl.Cluster(12, oracle).run(jobs, policy)
    return result, ledger, policy


def test_drift_ledger_equals_reference():
    ref_result, ref_ledger, ref_policy = _drift_run("ref")
    port_result, port_ledger, port_policy = _drift_run("port")
    assert port_result.metrics() == ref_result.metrics()
    assert port_policy.n_drift_alarms == ref_policy.n_drift_alarms > 0
    assert port_policy.refiner.n_drift_refits == \
        ref_policy.refiner.n_drift_refits
    assert port_ledger.to_dict() == _rename(ref_ledger.to_dict())
    assert port_ledger.state_dict() == _rename(ref_ledger.state_dict())
    # A snapshot restores and continues identically in the port.
    restored = po.PredictionLedger.from_json(port_ledger.to_json())
    assert restored.state_dict() == port_ledger.state_dict()


# ---------------------------------------------------------------------------
# Service mode: windows, SLO burn alarms, overload control
# ---------------------------------------------------------------------------


def _serve(which, elastic):
    cl, obs, ec = PKGS[which]
    monitor = obs.SLOMonitor(obs.SLOPolicy(6.0, objective=0.95),
                             fast_window_s=15.0, slow_window_s=60.0,
                             trip_burn=1.5, clear_burn=0.5)
    ctrl = obs.OverloadController(monitor, queue_floor=4,
                                  max_suspended=2 if elastic else 0)
    policy = obs.ControlledPolicy(cl.get_policy("fifo-static"), ctrl)
    oracle = cl.AnalyticOracle(noise=0.02, seed=11)
    cluster = ec(8, oracle) if elastic else cl.Cluster(8, oracle)
    cluster.metrics = obs.ClusterMetrics(window_s=30.0)
    health = []
    result = cluster.run_service(
        _stream(cl, "flash"), policy, until_jobs=300, health_every=60.0,
        on_health=lambda now, snap: health.append((now, snap)))
    return result, monitor, ctrl, cluster.metrics, health


@pytest.mark.parametrize("elastic", [False, True], ids=["cluster", "elastic"])
def test_service_control_equals_reference(elastic):
    ref = _serve("ref", elastic)
    port = _serve("port", elastic)
    assert port[0].metrics() == ref[0].metrics()
    assert [dataclasses.asdict(a) for a in port[1].alarms] == \
        [dataclasses.asdict(a) for a in ref[1].alarms]
    assert any(a.event == "trip" for a in port[1].alarms)
    assert port[1].budget() == ref[1].budget()
    assert [dataclasses.asdict(a) for a in port[2].log] == \
        [dataclasses.asdict(a) for a in ref[2].log]
    assert port[3].registry.to_prom_text() == ref[3].registry.to_prom_text()
    assert port[4] == ref[4]


def test_windows_equal_reference():
    rng = np.random.default_rng(0)
    ts = np.cumsum(rng.exponential(0.3, size=400))
    xs = rng.lognormal(0.0, 0.7, size=400)
    objs = {}
    for name, obs in (("ref", ro), ("port", po)):
        q = obs.WindowedQuantile(0.99, window_s=30.0, n_buckets=6)
        rate = obs.EwmaRate(tau_s=10.0)
        total = obs.RollingSum(window_s=20.0)
        p2 = obs.P2Quantile(0.5)
        trace = []
        for t, x in zip(ts, xs):
            q.observe(float(t), float(x))
            rate.observe(float(t))
            total.observe(float(t), float(x))
            p2.add(float(x))
            trace.append((q.value(float(t)), rate.rate(float(t)),
                          total.total(float(t)), p2.value))
        objs[name] = trace
    assert objs["port"] == objs["ref"]


@pytest.mark.parametrize("json_lines", [False, True])
def test_logger_equals_reference(json_lines):
    outs = {}
    for name, obs in (("ref", ro), ("port", po)):
        buf = io.StringIO()
        log = obs.Logger("cluster", level="info", json_lines=json_lines,
                         stream=buf)
        log.debug("hidden", msg="not shown")
        log.info("run", msg="20 jobs", jobs=20, oracle="sim-analytic-v1")
        log.warning("span_tiling", n=2, policy="predict-sjf")
        outs[name] = buf.getvalue()
    assert outs["port"] == outs["ref"] and outs["port"]
