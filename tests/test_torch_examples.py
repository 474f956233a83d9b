"""The port's examples (``python -m repro_torch.<name>``) on the CPU, at
tiny flags, against the reference's ``examples/`` where the output is
deterministic.

- ``mapreduce_wordcount``: every mode's counts equal the reference
  engine's ``collect_results`` for the same corpus and ``JobConfig``
  (the engine is integer-valued; modes change the schedule, never the
  counts); ``--workers 2`` runs two gloo rank processes.
- ``cluster_sim``: the analytic run's printed metrics equal the
  reference example's line for line; ``--real`` completes on the CPU.
- ``service_overload``: the whole printout (health lines, alarms, the
  controller's decision log, the final comparison) equals the reference
  example's, the trace's path aside.
- The trace demo (``make trace-demo``'s flags through
  ``python -m repro_torch.launch.cluster``): ``--metrics-out`` equals the
  reference CLI's, and its span tree passes ``SpanRecorder.check()``.
- ``elastic_preempt`` asserts bit-identity itself; its regrant pricing
  (analytic) equals the reference example's.
- ``serve_lm`` holds its decode against its teacher-forced forward itself
  (rtol and atol 2e-2, the reference's ``tests/test_models_smoke.py``).
- ``autotune_mesh`` fits on 3 of the 6 factorizations of 32 fake ranks
  and picks the fitted model's argmin.  (The reference example's degree-3
  fit on 3 samples raises "underdetermined" in ``core.fit``; the port's
  fits at degree 2.)
"""

import contextlib
import fcntl
import importlib.util
import io
import json
import pathlib
import re
import runpy
import sys
import tempfile

import numpy as np
import pytest

import repro.launch.cluster as rlaunch
import repro.mapreduce as ref
import repro_torch.launch.cluster as plaunch
from repro_torch import (autotune_mesh, cluster_sim, elastic_preempt, mapreduce_wordcount,
                         phase_breakdown, serve_lm, service_overload)
from repro_torch.obs import SpanRecorder

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
TOKENS = 4096


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(f"ref_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


@pytest.fixture
def ranks(tmp_path, tmp_path_factory, monkeypatch):
    """The session's rank-process lock (``tests/test_torch_shuffle.py``'s),
    rank worlds initialised under ``tmp_path``."""
    with open(tmp_path_factory.getbasetemp().parent / "gloo_ranks.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
        yield


def _reference_counts(M, R, W=1, depth=1, combiner=False):
    corpus = ref.wordcount_corpus(TOKENS, vocab_size=4096, seed=0)
    cfg = ref.JobConfig(num_mappers=M, num_reducers=R, num_workers=W,
                        overlap_depth=depth, combiner=combiner)
    ok, ov, _ = ref.build_job(ref.wordcount(4096), cfg, len(corpus))(corpus)
    return ref.collect_results(ok, ov)


def _wordcount(flags):
    return mapreduce_wordcount.main(["--device", "cpu", "--tokens", str(TOKENS), *flags])


@pytest.mark.parametrize("flags", [
    [], ["--phase-times"], ["--depth", "2"], ["--depth", "3", "--phase-times"],
    ["--combiner"], ["--combiner", "--phase-times"], ["--mappers", "7", "--reducers", "3"],
], ids=["fused", "traced", "pipelined", "pipelined-traced", "combiner", "combiner-traced",
        "ragged"])
def test_wordcount_counts_equal_reference(flags):
    out = _wordcount(flags)
    M = int(flags[flags.index("--mappers") + 1]) if "--mappers" in flags else 20
    R = int(flags[flags.index("--reducers") + 1]) if "--reducers" in flags else 5
    depth = int(flags[flags.index("--depth") + 1]) if "--depth" in flags else 1
    assert out["counts"] == _reference_counts(M, R, depth=depth, combiner="--combiner" in flags)
    assert out["dropped"] == 0 and out["wall_s"] > 0
    if "--phase-times" in flags:
        want = ["map"] + ["combine"] * ("--combiner" in flags) + ["shuffle", "reduce"]
        assert list(out["phase_times"])[:len(want)] == want
    else:
        assert out["phase_times"] is None


@pytest.mark.parametrize("flags", [["--phase-times"], ["--combiner"]], ids=["traced", "combiner"])
def test_wordcount_on_two_rank_processes(flags, ranks):
    out = _wordcount(["--workers", "2", *flags])
    assert out["counts"] == _reference_counts(20, 5, W=2, combiner="--combiner" in flags)
    if "--phase-times" in flags:
        assert list(out["phase_times"]) == ["map", "shuffle", "reduce"]


def test_wordcount_refuses_depth_with_workers():
    with pytest.raises(SystemExit):
        _wordcount(["--workers", "2", "--depth", "2"])


def test_phase_breakdown_tables_and_fits():
    report, text = _stdout(phase_breakdown.main,
                           ["--device", "cpu", "--tokens", "2048", "--repeats", "1"])
    assert set(report) == {"wordcount", "eximparse"}
    for app, r in report.items():
        assert len(r["traces"]) == len(phase_breakdown.CONFIGS)
        for (trace,) in r["traces"]:
            assert trace.phase_names() == ["map", "shuffle", "reduce", "collect"]
            assert trace.check_conservation() == []
            assert trace.counter("shuffle", "bytes_out") == \
                trace.counter("shuffle", "pairs_out") * 8
        assert np.isfinite([r["composed"], r["monolithic"]]).all() and r["actual"] > 0
    assert text.count("unseen (M, R) = (17, 9)") == 2


def _metric_lines(text):
    lines = text.splitlines()
    return lines[:next(i for i, s in enumerate(lines) if s.startswith("model database"))]


def test_cluster_sim_analytic_equals_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the reference's saved db
    monkeypatch.setattr(sys, "argv", ["cluster_sim.py"])
    _, want = _stdout(runpy.run_path, str(EXAMPLES / "cluster_sim.py"))
    metrics, got = _stdout(cluster_sim.main, [])
    assert _metric_lines(got) == _metric_lines(want)
    assert "round-tripped" in got and metrics["fifo-static"]["n_completed"] == 60


def test_cluster_sim_real_on_cpu():
    metrics, text = _stdout(cluster_sim.main, ["--real", "--device", "cpu"])
    assert "oracle=engine-wallclock" in text
    for name, m in metrics.items():
        assert m["n_completed"] + m["n_rejected"] == 6, name
    assert metrics["fifo-static"]["n_completed"] == 6


def test_service_overload_equals_reference(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _, want = _stdout(_reference_example("service_overload").main)
    out, got = _stdout(service_overload.main, ["--trace-out", str(tmp_path / "port.json")])

    def body(text):
        return [s for s in text.splitlines() if not s.startswith("wrote Chrome trace")]

    assert body(got) == body(want)
    assert out["decisions"] and json.loads((tmp_path / "port.json").read_text())["traceEvents"]


def test_trace_demo_metrics_equal_reference(tmp_path, monkeypatch):
    checks = []

    class Checked(SpanRecorder):
        def check(self, *args, **kwargs):
            checks.append(super().check(*args, **kwargs))
            return checks[-1]

    monkeypatch.setattr(plaunch, "SpanRecorder", Checked)
    flags = ["--jobs", "25", "--workers", "6", "--seed", "1", "--policies", "predict-elastic",
             "--elastic", "--suspend", "--mean-interarrival", "0.08", "--arrival", "bursty"]
    rlaunch.main([*flags, "--trace-out", str(tmp_path / "r.trace.json"),
                  "--metrics-out", str(tmp_path / "r.metrics.json")])
    plaunch.main(["--device", "cpu", *flags, "--trace-out", str(tmp_path / "p.trace.json"),
                  "--metrics-out", str(tmp_path / "p.metrics.json")])
    assert json.loads((tmp_path / "p.metrics.json").read_text()) == \
        json.loads((tmp_path / "r.metrics.json").read_text())
    assert checks == [[]]
    events = json.loads((tmp_path / "p.trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "job" for e in events)


def _remaining(text):
    return re.search(r"remaining (\S+)s -> (\S+)s", text).groups()


def test_elastic_preempt_resumes_bit_identical():
    out, got = _stdout(elastic_preempt.main, ["--device", "cpu"])
    _, want = _stdout(_reference_example("elastic_preempt").main)
    assert "bit-identical to the W=2 run" in got
    assert _remaining(got) == _remaining(want)
    c = out["cursor"]
    assert (c.map_tasks_done, c.mappers, c.shuffled) == (4, 8, False)
    assert sum(out["counts"].values()) == 6000


def test_serve_lm_decodes_as_its_forward():
    out, text = _stdout(serve_lm.main, ["--device", "cpu"])
    assert np.isfinite(out["decode_vs_forward"])  # main raises past its tolerance
    assert out["generated"].shape == (4, 48)
    assert set(out["ms_per_token"]) == {1, 2, 4, 8}
    assert np.isfinite(out["predicted_batch6_s"]) and "batch=6" in text


def test_autotune_mesh_fits_half_the_space():
    import torch.distributed as dist

    out, text = _stdout(autotune_mesh.main, [])
    assert len(out["space"]) == 6 and len(out["sample"]) == 3
    assert [tuple(r) for r in out["sample"]] == [tuple(r) for r in out["space"][::2]]
    assert out["chosen"] == int(np.argmin(out["predicted"]))
    assert all(t > 0 for t in out["exhaustive"])
    assert out["regret_pct"] >= 0 and "tuner regret" in text
    assert not dist.is_initialized()
    assert (out["space"].prod(axis=1) == 32).all()
