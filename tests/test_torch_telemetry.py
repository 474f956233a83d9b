"""The port's traced mode and telemetry layer against the reference's, on
the CPU.

The same seeded corpus and configuration go through the reference's
``build_job(..., recorder=PhaseRecorder())`` and the port's; outputs must
agree bit for bit and every counter of every phase must be equal (the
clock-valued ``cpu_s``, ``net_s`` and ``cpu_workers`` aside).  Traces
cross between the packages through their JSON form.  The per-phase models
are held against the reference's to ``tests/test_regression.py``'s
tolerances.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.mapreduce as ref
import repro.telemetry as rtel
import repro_torch.mapreduce as port
import repro_torch.telemetry as ptel
from repro.core.regression import fit as ref_fit
from repro_torch.convert import REFERENCE_BACKEND_NAMES, job_config_from_reference
from repro_torch.core.predictor import ModelDatabase
from repro_torch.core.regression import fit
from repro_torch.mapreduce.phases import PAIR_BYTES

REF_BACKEND = {v: k for k, v in REFERENCE_BACKEND_NAMES.items()}
CLOCKS = ("cpu_s", "net_s", "cpu_workers")
APPS = {
    "wordcount": (ref.wordcount(97), port.wordcount(97),
                  ref.wordcount_corpus(1500, vocab_size=97, seed=4)),
    "eximparse": (ref.eximparse(40), port.eximparse(40),
                  ref.exim_mainlog(1201, 40, seed=5)),
}


def _traced(app="wordcount", depth=1, collect=False, **kw):
    """One traced run in each package: (port trace, port out, ref trace,
    ref out)."""
    ref_app, port_app, corpus = APPS[app]
    kw.setdefault("num_mappers", 4)
    kw.setdefault("num_reducers", 3)
    kw.setdefault("capacity_factor", 8.0)
    ref_cfg = ref.JobConfig(overlap_depth=depth, **kw)
    port_cfg = job_config_from_reference(dataclasses.asdict(ref_cfg))
    rrec, prec = rtel.PhaseRecorder(), ptel.PhaseRecorder()
    rout = ref.build_job(ref_app, ref_cfg, len(corpus), recorder=rrec)(corpus)
    pout = port.build_job(port_app, port_cfg, len(corpus), recorder=prec,
                          device="cpu")(corpus)
    if collect:
        rtel.collect_traced(rrec.last, rout[0], rout[1])
        ptel.collect_traced(prec.last, pout[0], pout[1])
    return prec.last, pout, rrec.last, rout


def _counters(trace):
    return [(p.phase, {k: v for k, v in p.counters.items() if k not in CLOCKS})
            for p in trace.phases]


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------- traced execution

@pytest.mark.parametrize("app", sorted(APPS))
def test_traced_output_matches_fused(app):
    _, port_app, corpus = APPS[app]
    cfg = port.JobConfig(num_mappers=5, num_reducers=4, capacity_factor=8.0)
    fused = port.build_job(port_app, cfg, len(corpus), device="cpu")(corpus)
    recorder = ptel.PhaseRecorder()
    traced = port.build_job(port_app, cfg, len(corpus), recorder=recorder,
                            device="cpu")(corpus)
    for t, f in zip(traced, fused):
        assert torch.equal(t, f)
    assert recorder.last.phase_names() == ["map", "shuffle", "reduce"]


def test_recorder_accumulates_per_call():
    _, port_app, corpus = APPS["wordcount"]
    recorder = ptel.PhaseRecorder()
    job = port.build_job(port_app, port.JobConfig(2, 2), len(corpus),
                         recorder=recorder, device="cpu")
    for _ in range(3):
        job(corpus)
    assert len(recorder) == 3
    assert recorder.last is recorder.traces[-1]
    assert set(recorder.mean_phase_times()) == {"map", "shuffle", "reduce"}


@pytest.mark.parametrize("backend", ["torch", "scatter_reduce", "cuda"])
@pytest.mark.parametrize("app,combiner", [("wordcount", False), ("wordcount", True),
                                          ("eximparse", False)])
@pytest.mark.parametrize("M,R,W", [(4, 3, 1), (5, 3, 2), (7, 5, 3)])
def test_counters_equal_the_reference(backend, app, combiner, M, R, W):
    """Every counter of every phase, collect included, as the reference
    counts it; the outputs bit for bit; the conservation laws hold."""
    trace, out, rtrace, rout = _traced(
        app, collect=True, num_mappers=M, num_reducers=R, num_workers=W,
        combiner=combiner, reduce_backend=REF_BACKEND[backend])
    _assert_same(out, rout)
    assert _counters(trace) == _counters(rtrace)
    assert trace.check_conservation() == []
    assert trace.config == {**rtrace.config, "reduce_backend": backend}
    if combiner:
        assert trace.counter("combine", "net_bytes") == 0
        assert trace.counter("combine", "pairs_out") < trace.counter("map", "pairs_emitted")


def test_counters_measured_not_config_derived():
    """A capacity factor small enough to drop pairs: the counters follow
    the outputs."""
    _, port_app, corpus = APPS["wordcount"]
    recorder = ptel.PhaseRecorder()
    ok, ov, dropped = port.build_job(
        port_app, port.JobConfig(4, 3, capacity_factor=0.5), len(corpus),
        recorder=recorder, device="cpu")(corpus)
    trace = recorder.last
    assert int(dropped) > 0
    assert trace.counter("map", "pairs_emitted") == len(corpus)
    assert trace.counter("shuffle", "pairs_out") == len(corpus) - int(dropped)
    assert trace.counter("shuffle", "bytes_dropped") == int(dropped) * PAIR_BYTES
    assert trace.counter("reduce", "segments_out") == int((ok != port.PAD_KEY).sum())
    assert trace.check_conservation() == []


def test_phase_times_sum_to_total():
    trace, _, _, _ = _traced(num_mappers=6, num_reducers=5)
    assert trace.total_s is not None
    assert trace.phase_time_sum() <= trace.total_s * 1.01
    assert abs(trace.total_s - trace.phase_time_sum()) <= max(0.5 * trace.total_s, 0.1)
    for p in trace.phases:
        assert p.wall_s >= 0 and p.counters["cpu_s"] >= 0


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("combiner", [False, True])
def test_pipelined_trace_records_pipeline_phase(depth, combiner):
    trace, out, rtrace, rout = _traced(depth=depth, num_mappers=7, num_reducers=5,
                                       num_workers=2, combiner=combiner)
    _assert_same(out, rout)
    assert trace.phase_names()[-1] == "pipeline"
    assert trace.phase_names() == rtrace.phase_names()
    assert _counters(trace) == _counters(rtrace)
    pipe = trace.phase("pipeline")
    assert pipe.counters["overlap_depth"] == depth
    assert pipe.counters["net_bytes"] == 0.0 and pipe.wall_s >= 0
    assert trace.check_conservation() == []


def test_failed_run_leaves_no_trace():
    _, port_app, corpus = APPS["wordcount"]
    recorder = ptel.PhaseRecorder()
    job = port.build_job(port_app, port.JobConfig(2, 2), len(corpus),
                         recorder=recorder, device="cpu")
    job(corpus)
    with pytest.raises(ValueError, match="expected"):
        job(corpus[:-1])
    assert len(recorder) == 1


def test_max_traces_bounds_retention():
    _, port_app, corpus = APPS["wordcount"]
    with pytest.raises(ValueError, match="max_traces"):
        ptel.PhaseRecorder(max_traces=0)
    recorder = ptel.PhaseRecorder(max_traces=2)
    job = port.build_job(port_app, port.JobConfig(2, 2), len(corpus),
                         recorder=recorder, device="cpu")
    firsts = []
    for _ in range(4):
        job(corpus)
        firsts.append(recorder.last)
    assert recorder.traces == firsts[-2:]


# ------------------------------------------------------------ conservation

def test_check_conservation_flags_violations():
    trace = ptel.JobTrace(app="x", config={})
    trace.record_phase("map", 0.0, pairs_emitted=10)
    trace.record_phase("shuffle", 0.0, pairs_in=10, pairs_out=3, pairs_dropped=2,
                       bytes_in=80, bytes_out=24, bytes_dropped=16)
    bad = trace.check_conservation()
    assert any("bytes" in b for b in bad)
    assert any("pairs" in b for b in bad)


def test_check_conservation_flags_combine_violations():
    def run(combine_out, shuffle_in, combine_in=10):
        trace = ptel.JobTrace(app="x", config={})
        trace.record_phase("map", 0.0, pairs_emitted=10)
        trace.record_phase("combine", 0.0, pairs_in=combine_in, pairs_out=combine_out,
                           bytes_in=combine_in * 8, bytes_out=combine_out * 8)
        trace.record_phase("shuffle", 0.0, pairs_in=shuffle_in, pairs_out=shuffle_in,
                           pairs_dropped=0, bytes_in=shuffle_in * 8,
                           bytes_out=shuffle_in * 8, bytes_dropped=0)
        return trace.check_conservation()

    assert run(6, 6) == []
    bad = run(12, 12)
    assert any("combine pairs_out" in v and "> pairs_in" in v for v in bad)
    assert any("combine bytes_out" in v for v in bad)
    assert any("combine pairs_out" in v and "shuffle pairs_in" in v for v in run(6, 9))
    assert any("map pairs_emitted" in v and "combine pairs_in" in v
               for v in run(6, 6, combine_in=8))


def test_check_conservation_flags_nonshuffle_net_bytes_and_cpu():
    trace = ptel.JobTrace(app="x", config={})
    trace.record_phase("map", 0.0, pairs_emitted=4)
    trace.record_phase("combine", 0.0, pairs_in=4, pairs_out=4, net_bytes=32)
    trace.record_phase("reduce", 0.01, cpu_s=5.0, cpu_workers=2.0)
    bad = trace.check_conservation()
    assert any("only shuffle occupies the fabric" in v for v in bad)
    assert any("reduce cpu_s" in v for v in bad)


# ------------------------------------------------------------ serialisation

def test_traces_cross_between_packages_as_json():
    """A reference trace's JSON loads in the port and the reverse; the
    loaded trace is the other package's, field for field."""
    trace, _, rtrace, _ = _traced(collect=True, combiner=True)
    from_ref = ptel.JobTrace.from_json(rtrace.to_json())
    from_port = rtel.JobTrace.from_json(trace.to_json())
    assert from_ref.to_dict() == rtrace.to_dict()
    assert from_port.to_dict() == trace.to_dict()
    assert from_ref.check_conservation() == []
    assert ptel.JobTrace.from_dict(trace.to_dict()).to_json() == trace.to_json()
    assert ptel.TRACE_SCHEMA_VERSION == rtel.TRACE_SCHEMA_VERSION
    with pytest.raises(ValueError, match="schema"):
        ptel.JobTrace.from_dict({**trace.to_dict(), "schema": 99})
    with pytest.raises(ValueError, match="JSON object"):
        ptel.JobTrace.from_json("[1, 2]")


def test_collect_traced_appends_phase():
    trace, _, rtrace, _ = _traced(collect=True)
    assert trace.phase_names() == ["map", "shuffle", "reduce", "collect"]
    assert trace.counter("collect", "unique_keys") == rtrace.counter("collect", "unique_keys")


# ------------------------------------------------------------------ models

def _synthetic(n=25, seed=0):
    """tests/test_telemetry.py's analytic per-phase targets."""
    rng = np.random.default_rng(seed)
    params = rng.uniform(5, 40, size=(n, 2))
    m, r = params[:, 0], params[:, 1]
    times = {"map": 0.2 + 0.01 * m + 1e-4 * m**2,
             "shuffle": 0.5 + 0.02 * r,
             "reduce": 0.1 + 30.0 / r}
    targets = {(p, "time_s"): v for p, v in times.items()}
    targets[("shuffle", "bytes_out")] = 8000.0 + 10.0 * r
    return params, targets


def test_resource_keys_as_the_reference():
    for phase, res in [("shuffle", "bytes_out"), ("map", "time_s")]:
        key = ptel.phase_resource_key(phase, res)
        assert key == rtel.phase_resource_key(phase, res)
        assert ptel.split_resource_key(key) == (phase, res)
    for bad in [("a:b", "c"), ("", "x"), ("p", "")]:
        with pytest.raises(ValueError):
            ptel.phase_resource_key(*bad)
    with pytest.raises(ValueError):
        ptel.split_resource_key("no-separator")
    assert ptel.PHASE_ORDER == rtel.PHASE_ORDER
    assert ptel.DEFAULT_COUNTER_TARGETS == rtel.DEFAULT_COUNTER_TARGETS


def test_phase_models_match_the_reference():
    """fit_phase_models, predict_total and composed_vs_monolithic on the
    same targets, against the reference's, to test_regression.py's 1e-4."""
    params, targets = _synthetic()
    pms = ptel.fit_phase_models(params, targets, device="cpu")
    rpms = rtel.fit_phase_models(params, targets)
    assert pms.time_phases() == rpms.time_phases() == ["map", "shuffle", "reduce"]
    np.testing.assert_allclose(pms.predict_total(params, "cpu"),
                               rpms.predict_total(params), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(pms.predict("shuffle", "bytes_out", params, "cpu"),
                               rpms.predict("shuffle", "bytes_out", params),
                               rtol=1e-4, atol=1e-6)
    totals = sum(targets[(p, "time_s")] for p in ("map", "shuffle", "reduce"))
    stats = ptel.composed_vs_monolithic(pms, fit(params, totals, device="cpu"),
                                        params, totals, device="cpu")
    rstats = rtel.composed_vs_monolithic(rpms, ref_fit(params, totals), params, totals)
    assert stats["composed_le_monolithic"] and rstats["composed_le_monolithic"]
    for key in ("composed_mean_pct", "monolithic_mean_pct", "composed_max_pct"):
        np.testing.assert_allclose(stats[key], rstats[key], rtol=1e-4, atol=1e-4)
    per_phase = pms.predict_phase_times(params, "cpu")
    np.testing.assert_allclose(pms.predict_total(params, "cpu"),
                               np.sum(list(per_phase.values()), axis=0))


def test_phase_models_from_traces_match_the_reference():
    """Models fitted on traced runs at five (M, R) settings: the targets
    (counters exactly, wall times as measured) give the same fits."""
    rows, port_traces, ref_traces = [], [], []
    for M, R in [(2, 2), (3, 2), (4, 3), (5, 4), (6, 5)]:
        trace, _, rtrace, _ = _traced(num_mappers=M, num_reducers=R)
        rows.append([M, R])
        port_traces.append([trace])
        ref_traces.append([rtrace])
    targets = ptel.targets_from_traces(port_traces)
    rtargets = rtel.targets_from_traces(ref_traces)
    assert set(targets) == set(rtargets)
    for key in targets:
        if key[1] not in ("time_s",) + CLOCKS:
            np.testing.assert_array_equal(targets[key], rtargets[key])
    pms = ptel.fit_phase_models(rows, targets, degree=1, device="cpu")
    rpms = rtel.fit_phase_models(rows, targets, degree=1)
    np.testing.assert_allclose(pms.predict("map", "pairs_emitted", rows, "cpu"),
                               rpms.predict("map", "pairs_emitted", rows),
                               rtol=1e-4, atol=1e-3)


def test_phase_models_publish_and_load(tmp_path):
    params, targets = _synthetic()
    pms = ptel.fit_phase_models(params, targets, device="cpu")
    db = ModelDatabase()
    db.put("wc", "plat", fit(params, targets[("map", "time_s")], device="cpu"))
    pms.publish(db, "wc", "plat", backend="torch")
    assert set(db.resources_for("wc", "plat", "torch")) == {
        "map:time_s", "shuffle:time_s", "reduce:time_s", "shuffle:bytes_out"}
    assert db.backends_for("wc", "plat") == [""]
    path = str(tmp_path / "db.json")
    db.save(path)
    loaded = ptel.PhaseModelSet.load(ModelDatabase.load(path), "wc", "plat", backend="torch")
    np.testing.assert_allclose(loaded.predict_total(params, "cpu"),
                               pms.predict_total(params, "cpu"), rtol=1e-12)
    with pytest.raises(ValueError, match="shape"):
        ptel.fit_phase_models(params[:-1], targets, device="cpu")
