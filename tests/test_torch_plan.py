"""The port's execution plan against the reference's, on the CPU.

The plan's metadata, its per-grant steppers and their cache, the fused
mode at other grants and the pipelined mode, each held against
``repro.mapreduce.plan.ExecutionPlan`` on the same seeded corpus and
configuration, bit for bit.  Each port reduce backend meets the reference
backend of the same role (``convert.REFERENCE_BACKEND_NAMES``); ``cuda``
runs its kernels' plain versions here.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.mapreduce as ref
import repro_torch.mapreduce as port
from repro_torch.convert import REFERENCE_BACKEND_NAMES, job_config_from_reference
from repro_torch.mapreduce import backends as port_backends
from repro_torch.mapreduce import engine as port_engine

CORPUS = ref.wordcount_corpus(360, vocab_size=53, seed=9)
EXIM = ref.exim_mainlog(601, 40, seed=4)
APPS = {
    "wordcount": (ref.wordcount(53), port.wordcount(53), CORPUS),
    "eximparse": (ref.eximparse(40), port.eximparse(40), EXIM),
}
PORT_BACKEND = dict(REFERENCE_BACKEND_NAMES)
REF_BACKEND = {v: k for k, v in PORT_BACKEND.items()}


def _cfgs(**kw):
    """(reference JobConfig, port JobConfig) for one setting."""
    kw.setdefault("num_mappers", 5)
    kw.setdefault("num_reducers", 3)
    kw.setdefault("num_workers", 2)
    kw.setdefault("capacity_factor", 8.0)
    kw.setdefault("reduce_backend", "jnp")
    ref_cfg = ref.JobConfig(**kw)
    return ref_cfg, job_config_from_reference(dataclasses.asdict(ref_cfg))


def _plans(app="wordcount", **kw):
    ref_app, port_app, corpus = APPS[app]
    ref_cfg, port_cfg = _cfgs(**kw)
    return (ref.ExecutionPlan(ref_app, ref_cfg, len(corpus)),
            port.ExecutionPlan(port_app, port_cfg, len(corpus), device="cpu"),
            corpus)


def _assert_same(got, want, ctx=None):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, ctx
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(ctx))


# ------------------------------------------------------------------ meta

@pytest.mark.parametrize("M,R,W", [(6, 4, 2), (5, 3, 2), (7, 5, 3), (3, 2, 4),
                                   (20, 5, 1), (37, 40, 4)])
@pytest.mark.parametrize("combiner", [False, True])
@pytest.mark.parametrize("depth", [1, 3])
def test_meta_and_partition_cap_match_reference(M, R, W, combiner, depth):
    """``meta()`` is the reference's dict, value for value, at the default
    grant and at other grants (W not dividing M included)."""
    rplan, pplan, _ = _plans(num_mappers=M, num_reducers=R, num_workers=W,
                             combiner=combiner, overlap_depth=depth)
    for workers in (None, 1, 2, 3, M + 1):
        assert pplan.meta(workers) == rplan.meta(workers), workers
        assert pplan.partition_cap(workers) == rplan.partition_cap(workers)
    m = pplan.meta()
    assert m["map_waves"] == math.ceil(M / W) and m["overlap_depth"] == depth
    assert m["partition_capacity"] == pplan.lex_capacity


# ------------------------------------------------------ fused at a grant

@pytest.mark.parametrize("app", sorted(APPS))
@pytest.mark.parametrize("workers", [1, 2, 3, 5, 9])
def test_fused_at_other_grants_matches_reference(app, workers):
    rplan, pplan, corpus = _plans(app, num_mappers=5, num_reducers=4, num_workers=2)
    want = rplan.fused(workers)(corpus)
    _assert_same(pplan.fused(workers)(corpus), want, workers)
    _assert_same(pplan.fused()(corpus), want, "default grant")


# ------------------------------------------------------------- pipelined

@pytest.mark.parametrize("backend", ["torch", "scatter_reduce", "cuda"])
@pytest.mark.parametrize("combiner", [False, True])
@pytest.mark.parametrize("M,R,W", [(5, 3, 2), (7, 5, 3), (3, 2, 4), (7, 3, 2)])
def test_pipelined_bit_exact_vs_fused_and_reference(backend, combiner, M, R, W):
    """Depths 1-3 against the port's fused mode and the reference's
    pipelined mode.  (7, 5, 3) is ragged twice over: W does not divide M
    and D does not divide the waves, so the epilogue group clamps back
    onto tasks already done."""
    rplan, pplan, corpus = _plans(num_mappers=M, num_reducers=R, num_workers=W,
                                  combiner=combiner,
                                  reduce_backend=REF_BACKEND[backend])
    fused = pplan.fused()(corpus)
    for depth in (1, 2, 3):
        got = pplan.pipelined(depth=depth)(corpus)
        for g, f in zip(got, fused):
            assert torch.equal(g, f), depth
        _assert_same(got, rplan.pipelined(depth=depth)(corpus), depth)


@pytest.mark.parametrize("app", sorted(APPS))
def test_pipelined_ragged_groups_match_reference(app):
    """The smoke's ragged (37, 40, 4) at depths 2 and 3: 10 map waves in
    groups of 8 or 12 tasks, the reduce waves in groups of 8 or 12 of 40."""
    rplan, pplan, corpus = _plans(app, num_mappers=37, num_reducers=40, num_workers=4)
    fused = pplan.fused()(corpus)
    for depth in (2, 3):
        got = pplan.pipelined(depth=depth)(corpus)
        assert all(torch.equal(g, f) for g, f in zip(got, fused))
        _assert_same(got, rplan.pipelined(depth=depth)(corpus), depth)


class _CountingBackend(port_backends.CudaReduceBackend):
    """The ``cuda`` backend (its kernels' plain versions on the CPU),
    counting its ``reduce`` and ``combine`` calls: one kernel launch each
    on the card."""

    name = "counting"

    def __init__(self):
        self.reduces = self.combines = 0

    def reduce(self, keys, values, reduce_op, addend=None, out=None):
        self.reduces += 1
        return super().reduce(keys, values, reduce_op, addend, out)

    def combine(self, keys, values, reduce_op):
        self.combines += 1
        return super().combine(keys, values, reduce_op)


@pytest.fixture
def counting():
    backend = port_backends.register_reduce_backend(_CountingBackend())
    yield backend
    del port_backends.REDUCE_BACKENDS[backend.name]


@pytest.mark.parametrize("M,R,W", [(20, 5, 1), (7, 3, 2), (37, 40, 4)])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipelined_reduce_calls_per_wave_group(counting, M, R, W, depth):
    """One backend ``reduce`` a wave group, ceil(R / min(W·D, R)) a job, and
    one ``combine`` a combiner job: on the card, that many ``segment_reduce``
    and ``local_reduce`` launches."""
    _, port_app, corpus = APPS["wordcount"]
    cfg = port.JobConfig(M, R, W, capacity_factor=8.0, reduce_backend="counting",
                         combiner=True, overlap_depth=depth)
    plan = port.ExecutionPlan(port_app, cfg, len(corpus), device="cpu")
    plan.pipelined()(corpus)
    assert counting.reduces == math.ceil(R / min(W * depth, R))
    assert counting.combines == 1


def test_overlap_depth_validated():
    _, pplan, corpus = _plans()
    for depth in (0, -1):
        with pytest.raises(ValueError, match="overlap depth"):
            pplan.pipelined(depth=depth)
        with pytest.raises(ValueError, match="overlap depth"):
            pplan.pipelined_phase_fns(depth=depth)
        with pytest.raises(ValueError, match="overlap_depth"):
            port.JobConfig(2, 2, overlap_depth=depth)
    # depth 1 is the serial phase functions, as in the reference
    assert set(pplan.pipelined_phase_fns(depth=1)) == set(pplan.phase_fns())


@pytest.mark.parametrize("depth,mode", [(1, "fused"), (2, "pipelined"), (3, "pipelined")])
def test_build_job_routes_overlap_depth(monkeypatch, depth, mode):
    calls = []
    for name in ("fused", "pipelined", "traced"):
        orig = getattr(port_engine.ExecutionPlan, name)
        monkeypatch.setattr(port_engine.ExecutionPlan, name,
                            lambda self, *a, _o=orig, _n=name, **k:
                            calls.append(_n) or _o(self, *a, **k))
    ref_app, port_app, corpus = APPS["wordcount"]
    ref_cfg, port_cfg = _cfgs(overlap_depth=depth)
    got = port.build_job(port_app, port_cfg, len(corpus), device="cpu")(corpus)
    assert calls == [mode]
    _assert_same(got, ref.build_job(ref_app, ref_cfg, len(corpus))(corpus))


# --------------------------------------------------------------- steppers

def _call_sequence(plan):
    """The call sequence of the reference's TestStepperCaches, run on a
    plan of either package."""
    plan.map_stepper(5)
    plan.map_stepper(9)       # W >= M: the same stepper as 5
    plan.map_stepper(2)
    plan.map_stepper(3)
    cap = plan.partition_cap()
    plan.reduce_stepper(3, cap)
    plan.reduce_stepper(7, cap)  # W >= R: the same stepper as 3
    plan.shuffle_stepper(2)
    plan.shuffle_stepper(5)   # lexsort: W-independent
    plan.combine_stepper()
    plan.combine_stepper()
    plan.pipelined(depth=2)
    plan.pipelined(depth=2)
    plan.pipelined(depth=3)
    plan.pipelined(workers=3, depth=2)


@pytest.mark.parametrize("combiner", [False, True])
def test_cache_info_matches_reference(combiner):
    rplan, pplan, _ = _plans(combiner=combiner)  # M=5, R=3
    assert pplan.cache_info() == rplan.cache_info()
    _call_sequence(rplan)
    _call_sequence(pplan)
    assert pplan.cache_info() == rplan.cache_info()
    assert set(pplan._map) == set(rplan._jit_map)
    assert set(pplan._reduce) == set(rplan._jit_reduce)
    assert set(pplan._shuffle) == set(rplan._jit_shuffle)
    assert set(pplan._pipelined) == set(rplan._jit_pipelined)


def test_equivalent_grants_share_steppers():
    _, plan, _ = _plans()  # M=5, R=3
    assert plan.map_stepper(5) is plan.map_stepper(9)
    assert plan.map_stepper(2) is not plan.map_stepper(3)
    cap = plan.partition_cap()
    assert plan.reduce_stepper(3, cap) is plan.reduce_stepper(7, cap)
    info = plan.cache_info()
    assert info["map_entries"] == 3 and info["reduce_entries"] == 1
    assert info["hits"] == 2 and info["misses"] == 4
    a = plan.pipelined(depth=2)
    assert plan.pipelined(depth=2) is a and plan.pipelined(depth=3) is not a
    assert plan.prep() is plan.prep()


@pytest.mark.parametrize("app,combiner", [("wordcount", False), ("wordcount", True),
                                           ("eximparse", False)])
@pytest.mark.parametrize("W", [1, 2, 3, 6])
def test_steppers_driven_by_hand_match_reference(app, combiner, W):
    """prep, then the map, combine, shuffle and reduce steppers at grant W,
    wave by wave, give the reference's fused output (and its steppers')."""
    rplan, pplan, corpus = _plans(app, combiner=combiner)
    splits, valid = pplan.prep()(corpus)
    rsplits, rvalid = rplan.prep()(corpus)
    _assert_same((splits, valid), (rsplits, rvalid))
    bufs = pplan.initial_map_buffers()
    rbufs = rplan.initial_map_buffers()
    step, rstep = pplan.map_stepper(W), rplan.map_stepper(W)
    for i in range(math.ceil(pplan.M / W)):
        bufs = step(splits, valid, *bufs, i * W)
        rbufs = rstep(rsplits, rvalid, *rbufs, i * W)
    _assert_same(bufs, rbufs, "map")
    if combiner:
        bufs = pplan.combine_stepper()(*bufs)
        rbufs = rplan.combine_stepper()(*rbufs)
        _assert_same(bufs, rbufs, "combine")
    pk, pv, dropped, ok, ov = pplan.shuffle_stepper(W)(*bufs)
    rpk, rpv, rdropped, rok, rov = rplan.shuffle_stepper(W)(*rbufs)
    _assert_same((pk, pv, dropped), (rpk, rpv, rdropped), "shuffle")
    assert ok.shape == ov.shape == pk.shape
    step = pplan.reduce_stepper(W, pk.shape[1])
    rstep = rplan.reduce_stepper(W, rpk.shape[1])
    for i in range(math.ceil(pplan.R / W)):
        ok, ov = step(pk, pv, ok, ov, i * W)
        rok, rov = rstep(rpk, rpv, rok, rov, i * W)
    _assert_same((ok, ov), (rok, rov), "reduce")
    _assert_same((ok, ov, dropped), rplan.fused()(corpus), "fused")
