"""``portbench/spans.py``: the readings of the program's spans, on made-up
records and on a CPU profile of a cell's fused jobs at a tiny size."""

import time

import pytest

from portbench import harness, profiling, spans
from portbench.spec import load_cell

TOKENS = 1 << 13
SEED = 2**32 + 7


def _records(**kw):
    n = {s: 0 for s in spans.SPANS}
    n.update({"mapreduce.job": 4, "mapreduce.map": 4, "mapreduce.shuffle": 4,
              "mapreduce.shuffle.sort": 4})
    rec = {
        "span_n": n,
        "span_s": {s: 0.0 for s in spans.SPANS} | {
            "mapreduce.map": 0.16, "mapreduce.shuffle": 0.36,
            "mapreduce.shuffle.sort": 0.2},
        "span_jobs": 4,
        "launches": 800,
        "device_op_s": 0.7,
        "idle_in_job_s": 0.002,
        "window_s": 0.8,
    }
    rec.update(kw)
    return rec


def test_span_names_are_the_programs():
    from repro_torch.mapreduce.spans import SPANS

    assert spans.SPANS == SPANS
    assert set(spans.DEVICE_MS.values()) <= set(SPANS)
    assert len(spans.METRICS) == 16


@pytest.mark.parametrize("metric,want", [
    ("map.device_ms", 40.0),
    ("shuffle.device_ms", 90.0),
    ("shuffle.sort_ms", 50.0),
    ("plan.launches", 200.0),
    ("device.idle_in_job_pct", 0.25),
    ("combine.device_ms", None),       # the span is absent
    ("reduce.device_ms", None),
    ("map.spill_sort_ms", None),
    ("shuffle.gather_ms", None),
    ("shuffle.scatter_ms", None),
    ("shuffle.split_ms", None),
    ("shuffle.merge_ms", None),
    ("shuffle.pack_ms", None),
    ("shuffle.exchange_ms", None),
    ("shuffle.unpack_ms", None),
    ("gather.device_ms", None),
])
def test_readings_of_made_up_records(metric, want):
    got = spans.read(metric, _records())
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("metric", spans.METRICS)
def test_a_program_without_spans_reads_none(metric):
    """The records of a program that opens no spans, and of none at all."""
    empty = _records(span_n={s: 0 for s in spans.SPANS},
                     span_s={s: 0.0 for s in spans.SPANS}, span_jobs=0, launches=0,
                     idle_in_job_s=0.0)
    assert spans.read(metric, empty) is None
    assert spans.read(metric, {}) is None


def test_an_unknown_metric_is_refused():
    with pytest.raises(KeyError):
        spans.read("map.host_ms", _records())


def _profiled(name, rounds=2):
    """A CPU profile of ``rounds`` rounds of the cell's fused jobs."""
    from portbench import gen
    from repro_torch.mapreduce import build_job

    cell = load_cell(name)
    corpus = gen.corpus(cell.config, SEED, "cpu", TOKENS)
    mix = cell.jobs()
    jobs = [build_job(cell.app(TOKENS), m.job_config(), TOKENS, device="cpu")
            for m in mix]
    harness.run_rounds(jobs, corpus, "cpu", 1)
    with profiling.traced("cpu") as box:
        harness.run_rounds(jobs, corpus, "cpu", rounds)
    return box, rounds * len(mix)


@pytest.mark.parametrize("name", ["wc-combine", "exim-sweep"])
def test_records_of_a_cpu_profile(name):
    box, jobs = _profiled(name)
    rec = spans.records(box)
    assert rec["span_jobs"] == jobs
    for phase in ("mapreduce.map", "mapreduce.shuffle", "mapreduce.reduce",
                  "mapreduce.shuffle.sort", "mapreduce.shuffle.gather",
                  "mapreduce.shuffle.scatter", "mapreduce.map.spill_sort"):
        assert rec["span_n"][phase] >= jobs, phase
    assert (rec["span_n"]["mapreduce.combine"] > 0) == (name == "wc-combine")
    # no card: no device operation, so every job span is idle time
    assert rec["launches"] == 0 and rec["device_op_s"] == 0
    assert 0 < rec["idle_in_job_s"] <= box["window_s"]
    assert spans.idle_gaps(box) == []


def test_records_of_a_program_that_opens_no_spans(monkeypatch):
    from repro_torch.mapreduce import spans as program_spans

    monkeypatch.setattr(program_spans, "_recording", lambda: False)
    box, _ = _profiled("wc-combine", rounds=1)
    rec = {**spans.records(box), "window_s": box["window_s"]}
    assert rec["span_jobs"] == 0 and not any(rec["span_n"].values())
    assert all(spans.read(m, rec) is None for m in spans.METRICS)


def test_a_traced_cpu_run_keeps_its_metrics():
    """A whole ``--trace 1`` run of ``wc-combine`` with the program's spans
    in its jobs: correct, every metric a CPU run gives, as before; the
    spans' device times read nothing on the CPU."""
    cell = load_cell("wc-combine")
    line, _ = harness.run_local(cell, SEED, 0.3, True, time.time(), device="cpu",
                                tokens=TOKENS)
    assert line["correct"] is True
    layer = harness.metrics_for(cell, trace=True)
    assert {"shuffle.split_ms", "shuffle.merge_ms", "map.spill_sort_ms"} <= \
        {m["name"] for m in layer}
    assert set(line["metrics"]) == {m["name"] for m in layer
                                    if m["source"] != "device_trace"
                                    and m["name"] not in spans.DEVICE_MS}


def test_device_ms_needs_device_operations():
    """A CPU profile's spans hold no device operation: no device ms."""
    assert spans.read("map.device_ms", _records(device_op_s=0.0)) is None
    assert spans.read("map.device_ms", _records()) == pytest.approx(40.0)


def test_collectives_are_booked_to_their_innermost_span():
    """``span_comm_s`` books what a collective launched to the innermost
    program span around it, under the collective's host operation; the
    exchange's roofline reads the all-to-all's part of it."""
    rec = _records(span_comm_s={"mapreduce.shuffle.exchange": {
        "c10d::alltoall_base_": 0.004, "c10d::allreduce_": 0.002}},
        exchange_bytes=0.9e9, link_bytes_per_s=4.5e11)
    rec["span_n"]["mapreduce.shuffle.exchange"] = 4
    read = harness.read_layer("exchange.nvlink_pct", rec)
    assert read == pytest.approx(100.0 * 0.9e9 * 4 / 4.5e11 / 0.004)
    assert harness.read_layer("exchange.nvlink_pct", _records()) is None
