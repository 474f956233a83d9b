"""Whole runs of every cell on the CPU at a tiny size, past the look for a
card: ``correct`` comes out true for the program as it is, and false with
its timed path broken underneath, once for each fault the cell can have.

A fault is a function of pytest's ``monkeypatch.setattr``, undone after
the test.
"""

import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.reference import PAD_KEY
from portbench.spec import HERE, load_cell

CELLS = ["wc-fixed", "wc-combine", "exim-sweep"]
TOKENS = 1 << 13
SEED = 2**32 + 99


def half_of_each_task_left_out(set_attr):
    from repro_torch.mapreduce import phases, plan

    run = phases.run_map_task

    def broken(app, cfg, tokens, valid):
        valid = valid.clone()
        valid[:, valid.shape[1] // 2:] = False
        return run(app, cfg, tokens, valid)

    set_attr(phases, "run_map_task", broken)
    set_attr(plan, "run_map_task", broken)


def an_answer_altered(set_attr):
    from repro_torch.mapreduce.backends import CudaReduceBackend

    reduce = CudaReduceBackend.reduce

    def broken(self, keys, values, op):
        ok, ov = reduce(self, keys, values, op)
        live = (ok != PAD_KEY).reshape(-1).nonzero()
        ov = ov.clone()
        if len(live):
            ov.view(-1)[live[0]] += 1
        return ok, ov

    set_attr(CudaReduceBackend, "reduce", broken)


def values_cast_to_bfloat16(set_attr):
    from repro_torch.mapreduce.backends import CudaReduceBackend

    reduce = CudaReduceBackend.reduce

    def broken(self, keys, values, op):
        ok, ov = reduce(self, keys, values, op)
        return ok, ov.to(torch.bfloat16).to(ov.dtype)

    set_attr(CudaReduceBackend, "reduce", broken)


def a_pair_dropped_uncounted(set_attr):
    from repro_torch.mapreduce import backends

    scatter = backends.bucket_scatter

    def broken(ids, n_buckets, n_rows, cap, arrays, fills):
        outs, dropped = scatter(ids, n_buckets, n_rows, cap, arrays, fills)
        live = (outs[0] != fills[0]).reshape(-1).nonzero()
        if len(live):
            for out, fill in zip(outs, fills):
                out.reshape(-1)[live[-1]] = fill
        return outs, dropped

    set_attr(backends, "bucket_scatter", broken)


FAULTS = [half_of_each_task_left_out, an_answer_altered, values_cast_to_bfloat16,
          a_pair_dropped_uncounted]
CASES = [(c, f) for c in CELLS for f in FAULTS]


def _run(name, fault=None, monkeypatch=None):
    cell = load_cell(name)
    hook = (lambda: fault(monkeypatch.setattr)) if fault else None
    return harness.run_local(cell, SEED, 0.3, False, time.time(), device="cpu",
                             tokens=TOKENS, hook=hook)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    line, log = _run(name)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert line["checks"] == {"mismatched_slots": {"value": 0, "limit": 0}}
    assert list(line)[-1] == "checks"
    assert log[-1] == "check mismatched_slots 0 limit 0"
    want = {m["name"] for m in harness.metrics_for(load_cell(name), trace=False)}
    assert set(line["metrics"]) == want and "setup_s" in want


@pytest.mark.parametrize("name,fault", CASES, ids=lambda x: getattr(x, "__name__", x))
def test_a_fault_is_not_correct(name, fault, monkeypatch):
    line, log = _run(name, fault, monkeypatch)
    assert line["correct"] is False
    assert line["checks"]["mismatched_slots"]["value"] > 0
    assert line["failed"] >= 1


@pytest.mark.parametrize("name", ["wc-combine", "exim-sweep"])
def test_a_traced_run_reports_its_layers(name):
    cell = load_cell(name)
    line, _ = harness.run_local(cell, SEED, 0.3, True, time.time(), device="cpu",
                                tokens=TOKENS)
    assert line["correct"] is True
    # On the CPU the device metrics (device traces, and the device time
    # under the program's spans) have nothing to read and are left out;
    # the host clock's and the traced mode's phase walls are there.
    from portbench.spans import DEVICE_MS

    layer = harness.metrics_for(cell, trace=True)
    assert set(line["metrics"]) == {m["name"] for m in layer
                                    if m["source"] != "device_trace"
                                    and m["name"] not in DEVICE_MS}
    assert {"device_ops", "idle_gaps"} == set(line["breakdown"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    run = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "wc-combine", "--seed",
         str(2**31 + 5), "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, cwd=HERE.parent, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    import json

    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert all(0 < m["value"] <= 105 for k, m in line["metrics"].items()
               if k.endswith("roofline_pct"))
