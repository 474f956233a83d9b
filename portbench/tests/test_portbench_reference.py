"""The reference against the program at tiny sizes on the CPU, and the
check's rejections: a dropped pair, a value off by one, a value cast to
a lower precision, and the control (16-bit sums)."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench import gen, harness
from portbench.reference import Output, expected, mismatches
from portbench.spec import load_cell

CELLS = ["wc-fixed", "wc-combine", "exim-sweep", "wc-a2a-w4"]
SEED = 2**33 + 17


def _program(cell, job, corpus, backend):
    from repro_torch.mapreduce import ExecutionPlan

    cfg = dataclasses.replace(job, reduce_backend=backend).job_config()
    n = corpus.shape[0]
    return ExecutionPlan(cell.app(n), cfg, n, device="cpu").fused()(corpus)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_program(name, backend):
    cell = load_cell(name)
    n = 6007
    corpus = gen.corpus(cell.config, SEED, "cpu", n)
    mix = cell.jobs()
    for job in mix[:: max(1, len(mix) // 6)]:
        got = harness.read_output(_program(cell, job, corpus, backend))
        assert mismatches(expected(corpus, cell.shape(job, n)), got) == 0


@pytest.mark.parametrize("W,factor,combiner", [
    (8, 0.3, False), (3, 0.1, True), (4, 0.2, False), (4, 0.05, True)])
@pytest.mark.parametrize("app", ["wordcount", "exim"])
def test_reference_follows_the_capacities_that_drop(app, W, factor, combiner):
    """Small capacities drop pairs in the partition and cut runs inside a
    task."""
    cell = load_cell("wc-fixed" if app == "wordcount" else "exim-sweep")
    n = 20011
    corpus = gen.corpus(cell.config, SEED, "cpu", n)
    job = dataclasses.replace(cell.jobs()[0], mappers=9, reducers=5, workers=W,
                              capacity_factor=factor, combiner=combiner)
    out = _program(cell, job, corpus, "torch")
    want = expected(corpus, cell.shape(job, n))
    assert int(out[2]) == want.dropped > 0
    assert mismatches(want, harness.read_output(out)) == 0


def _exact_and_output(n=4099):
    cell = load_cell("exim-sweep")
    corpus = gen.corpus(cell.config, SEED, "cpu", n)
    job = cell.jobs()[5]
    want = expected(corpus, cell.shape(job, n))
    got = harness.read_output(_program(cell, job, corpus, "torch"))
    assert mismatches(want, got) == 0
    return want, got


def _changed(got, **fields):
    return dataclasses.replace(got, **fields)


def test_the_check_rejects_a_dropped_pair():
    want, got = _exact_and_output()
    vals = got.vals.copy()
    vals[3] -= int(got.vals[3])  # the pair's value gone, the drop not counted
    assert mismatches(want, _changed(got, vals=vals)) > 0
    keep = np.arange(len(got.pos)) != 3  # a whole key's only pair gone
    assert mismatches(want, _changed(got, pos=got.pos[keep], keys=got.keys[keep],
                                     vals=got.vals[keep])) > 0
    assert mismatches(want, _changed(got, dropped=got.dropped + 1)) > 0


def test_the_check_rejects_a_value_off_by_one():
    want, got = _exact_and_output()
    vals = got.vals.copy()
    vals[-1] += 1
    assert mismatches(want, _changed(got, vals=vals)) == 1


def test_the_check_rejects_a_value_cast_to_lower_precision():
    want, got = _exact_and_output()
    low = torch.from_numpy(got.vals).to(torch.bfloat16).to(torch.int64).numpy()
    assert mismatches(want, _changed(got, vals=low)) > 0
    dead = _changed(got, dead_nonzero=1)
    assert mismatches(want, dead) == 1


@pytest.mark.parametrize("name", ["wc-fixed", "exim-sweep", "wc-a2a-w4"])
def test_the_control_fails_where_sums_pass_2_to_the_15(name):
    """The reference summed in 16 bits (the control): at 2**20 tokens the
    commonest words' counts pass 2**15, and the keys 0-7 of the Exim splits
    that start inside a record sum the next record's id."""
    from portbench import control

    cell = load_cell(name)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  jobs=cell.traffic["jobs"][:3]))
    n = 1 << 20
    corpus = gen.corpus(cell.config, SEED, "cpu", n)
    want = expected(corpus, cell.shape(cell.jobs()[0], n))
    assert np.abs(want.vals).max() >= 2**15
    assert mismatches(want, Output(**vars(want), dead_nonzero=0)) == 0
    read = control.readings(cell, SEED, "cpu", tokens=n)
    assert all(n > 0 for n in read["per_job"])
