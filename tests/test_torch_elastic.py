"""The port's checkpoint and elastic layers against the reference's, on the
CPU.

``ResumableJob`` preempted at every wave boundary and resumed, against the
uninterrupted run, the fused mode and the reference's resumable job; the
state at every boundary against the reference's, array for array (the
accumulators a snapshot exposes hold PAD_KEY / 0 / False, as the
reference's do); regrant schedules; ``CheckpointManager``'s format,
retention and refusals; snapshots crossing between the packages both ways;
and ``RegrantCostModel`` / ``JobCursor`` as ``tests/test_elastic.py``
holds the reference's.  Every comparison is bit for bit.
"""

import dataclasses
import functools
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

import repro.checkpoint as rckpt
import repro.elastic as rel
import repro.mapreduce as ref
import repro_torch.elastic as pel
import repro_torch.mapreduce as port
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import (
    REFERENCE_BACKEND_NAMES,
    job_config_from_reference,
    snapshot_from_reference,
    snapshot_to_reference,
)
from repro_torch.elastic import (
    ElasticState,
    JobCursor,
    RegrantCostModel,
    ResumableJob,
    WorkProgress,
    load_snapshot,
    run_resumable,
    save_snapshot,
)

CORPUS = ref.wordcount_corpus(360, vocab_size=53, seed=9)
WANT = dict(Counter(np.asarray(CORPUS).tolist()))
SHUFFLES = ("lexsort", "all_to_all")


def _cfgs(**kw):
    kw.setdefault("num_mappers", 5)
    kw.setdefault("num_reducers", 3)
    kw.setdefault("num_workers", 2)
    kw.setdefault("capacity_factor", 8.0)
    ref_cfg = ref.JobConfig(**kw)
    return ref_cfg, job_config_from_reference(dataclasses.asdict(ref_cfg))


@functools.lru_cache(maxsize=None)
def _jobs(**kw):
    """(reference ResumableJob, port ResumableJob) for one setting; cached so
    each reference job compiles its steppers once per module."""
    ref_cfg, port_cfg = _cfgs(**kw)
    return (rel.ResumableJob(ref.wordcount(53), ref_cfg, len(CORPUS)),
            ResumableJob(port.wordcount(53), port_cfg, len(CORPUS), device="cpu"))


def _outputs(job, state):
    return tuple(np.asarray(torch.as_tensor(a)) for a in job.result(state))


def _assert_same(got, want, ctx=None):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=str(ctx))


def _arrays(state):
    return {k: np.asarray(torch.as_tensor(v)) for k, v in state.arrays.items()}


# --------------------------------------------------------------- resumable

@pytest.mark.parametrize("shuffle", SHUFFLES)
@pytest.mark.parametrize("combiner", [False, True])
def test_preempt_every_boundary_matches_fused_and_reference(shuffle, combiner):
    """Preempt after k steps and resume, for every k: equal to the
    uninterrupted run, to the fused mode and to the reference's result."""
    rjob, pjob = _jobs(shuffle_backend=shuffle, combiner=combiner)
    want = _outputs(rjob, rel.run_resumable(rjob, CORPUS))
    full = run_resumable(pjob, CORPUS)
    _assert_same(_outputs(pjob, full), want, "uninterrupted")
    _assert_same(pjob.plan.fused()(CORPUS), want, "fused")
    total = full.cursor.waves_executed
    assert total == full.cursor.steps_total() == 3 + 1 + int(combiner) + 2
    for k in range(1, total):
        part = run_resumable(pjob, CORPUS, preempt_after=k)
        assert part.cursor.waves_executed == k and not part.cursor.done
        _assert_same(_outputs(pjob, run_resumable(pjob, CORPUS, state=part)), want, k)


@pytest.mark.parametrize("shuffle", SHUFFLES)
@pytest.mark.parametrize("combiner", [False, True])
@pytest.mark.parametrize("ref_backend", ["jnp", "xla"])
def test_state_at_every_boundary_equals_reference(shuffle, combiner, ref_backend):
    """Step both packages one boundary at a time: cursors equal, and every
    array of ``ElasticState.arrays`` equal in shape, dtype and value, the
    rows a wave has not written yet included."""
    rjob, pjob = _jobs(shuffle_backend=shuffle, combiner=combiner,
                       reduce_backend=ref_backend)
    rstate, pstate = rjob.initial_state(), pjob.initial_state()
    while True:
        assert dataclasses.asdict(pstate.cursor) == dataclasses.asdict(dataclasses.replace(
            rstate.cursor, reduce_backend=REFERENCE_BACKEND_NAMES[ref_backend]))
        want = {k: np.asarray(v) for k, v in rstate.arrays.items()}
        got = _arrays(pstate)
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        if pstate.cursor.done:
            break
        rstate = rel.run_resumable(rjob, CORPUS, state=rstate, preempt_after=1)
        pstate = run_resumable(pjob, CORPUS, state=pstate, preempt_after=1)


def test_step_leaves_its_input_state_unchanged():
    """The plan's steppers write in place; a step writes into copies, so a
    state kept for a snapshot is not moved by later steps."""
    _, pjob = _jobs()
    state = run_resumable(pjob, CORPUS, preempt_after=1)
    before = _arrays(state)
    run_resumable(pjob, CORPUS, state=state)
    for name, arr in _arrays(state).items():
        np.testing.assert_array_equal(arr, before[name], err_msg=name)


@pytest.mark.parametrize("backend", ["torch", "scatter_reduce", "cuda"])
def test_regrant_any_schedule_bit_exact_lexsort(backend):
    """A lexsort job may change W at every boundary and still equal the
    fixed-grant run bit for bit."""
    cfg = port.JobConfig(5, 3, 2, capacity_factor=8.0, reduce_backend=backend)
    job = ResumableJob(port.wordcount(53), cfg, len(CORPUS), device="cpu")
    want = _outputs(job, run_resumable(job, CORPUS))
    grants = [3, 1, 4, 2, 5, 3, 1]
    state, i = job.initial_state(), 0
    while not state.cursor.done:
        state = job.regrant(state, grants[i % len(grants)])
        state = run_resumable(job, CORPUS, state=state, preempt_after=1)
        i += 1
    _assert_same(_outputs(job, state), want)


@pytest.mark.parametrize("combiner", [False, True])
def test_regrant_all_to_all_same_results(combiner):
    """The collective's partition layout follows the grant at the barrier,
    so the outputs' shapes change under 1 -> 4 -> 2, but with capacity
    headroom the collected results do not, and nothing drops; the same
    schedule in the reference gives the same partitions."""
    rjob, pjob = _jobs(shuffle_backend="all_to_all", combiner=combiner,
                       num_workers=1, capacity_factor=10.0)
    states = []
    for job, run in ((rjob, rel.run_resumable), (pjob, run_resumable)):
        state = run(job, CORPUS, preempt_after=1)  # the first map wave, W = 1
        state = run(job, CORPUS, state=job.regrant(state, 4),  # the rest of the
                    preempt_after=1 + int(combiner) + 1)       # map, the shuffle
        states.append(run(job, CORPUS, state=job.regrant(state, 2)))
    got = _outputs(pjob, states[1])
    assert got[2] == 0
    assert port.collect_results(got[0], got[1]) == WANT
    _assert_same(got, _outputs(rjob, states[0]))


def test_result_before_done_and_step_after_done_raise():
    _, job = _jobs()
    state = run_resumable(job, CORPUS, preempt_after=1)
    with pytest.raises(ValueError, match="not complete"):
        job.result(state)
    done = run_resumable(job, CORPUS, state=state)
    with pytest.raises(ValueError, match="complete"):
        job.step(done, CORPUS)


def test_plan_resumable_shares_the_plan():
    _, pjob = _jobs()
    job = pjob.plan.resumable()
    assert job.plan is pjob.plan
    _assert_same(_outputs(job, run_resumable(job, CORPUS)), pjob.plan.fused()(CORPUS))


def test_resumable_trace_segments_conserve():
    """A recorder gets one segment trace per ``run`` call, one phase entry
    per executed step; the segments' pairs add up to the corpus."""
    from repro_torch.telemetry import PhaseRecorder

    _, pjob = _jobs(combiner=True)
    recorder = PhaseRecorder()
    job = ResumableJob.from_plan(pjob.plan, recorder=recorder)
    state = job.run(CORPUS, preempt_after=2)
    job.run(CORPUS, state=state)
    first, second = recorder.traces
    assert first.phase_names() == ["map", "map"]
    assert second.phase_names() == ["map", "combine", "shuffle", "reduce", "reduce"]
    emitted = sum(p.counters["pairs_emitted"] for t in (first, second)
                  for p in t.phases if p.phase == "map")
    assert emitted == len(CORPUS)


# -------------------------------------------------------------- checkpoint

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"b": {"y": rng.integers(0, 9, (3, 4)).astype(np.int32),
                  "x": torch.from_numpy(rng.random(5) < 0.5)},
            "a": np.asarray("hello"),
            "c": torch.arange(6, dtype=torch.float32).reshape(2, 3)}


def test_checkpoint_round_trip_in_reference_layout(tmp_path):
    """Leaves in jax's flatten order (keys sorted, depth first), one .npy
    each, a manifest with paths and a null treedef, LATEST; restored
    without a template, with one, and onto a device."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree()
    mgr.save(7, tree)
    d = tmp_path / "step_000000007"
    assert sorted(os.listdir(d)) == ["MANIFEST.json"] + [f"arr_{i:06d}.npy" for i in range(4)]
    manifest = json.loads((d / "MANIFEST.json").read_text())
    assert manifest["paths"] == [["a"], ["b", "x"], ["b", "y"], ["c"]]
    assert manifest["treedef"] is None and manifest["n_leaves"] == 4
    assert [leaf["dtype"] for leaf in manifest["leaves"]] == ["<U5", "bool", "int32", "float32"]
    assert (tmp_path / "LATEST").read_text() == "7" and mgr.latest_step() == 7
    for like in (None, tree):
        got, step = mgr.restore(None, like=like)
        assert step == 7
        assert str(got["a"]) == "hello"
        np.testing.assert_array_equal(got["b"]["y"], tree["b"]["y"])
        np.testing.assert_array_equal(got["b"]["x"], tree["b"]["x"].numpy())
        np.testing.assert_array_equal(got["c"], tree["c"].numpy())
    got, _ = mgr.restore(7, device="cpu")
    assert isinstance(got["c"], torch.Tensor) and got["b"]["x"].dtype == torch.bool
    assert isinstance(got["a"], np.ndarray)


def test_checkpoint_keep_retention_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in range(1, 5):
        mgr.save_async(step, _tree(step))
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    got, step = mgr.restore(None)
    assert step == 4
    np.testing.assert_array_equal(got["b"]["y"], _tree(4)["b"]["y"])


def test_checkpoint_refuses_a_silent_cast(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"v": np.arange(4, dtype=np.int32)})
    with pytest.raises(ValueError, match="refusing a silent cast"):
        mgr.restore(1, like={"v": torch.zeros(4, dtype=torch.float32)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, like={"v": np.zeros(5, dtype=np.int32)})
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore(1, like={"v": np.zeros(4, dtype=np.int32), "w": np.zeros(1)})


def test_checkpoint_ignores_and_removes_tmp(tmp_path):
    """A crash mid-save leaves a .tmp directory: restore ignores it and the
    next manager removes it."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"v": np.arange(3, dtype=np.int32)})
    stale = tmp_path / "step_000000002.tmp"
    stale.mkdir()
    (stale / "MANIFEST.json").write_text("{")
    assert mgr.all_steps() == [1]
    got, step = mgr.restore(None)
    assert step == 1
    CheckpointManager(str(tmp_path))
    assert not stale.exists()


def test_checkpoint_of_a_list_needs_a_template(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"xs": [np.arange(2, dtype=np.int32), np.ones(3, dtype=np.int32)]}
    mgr.save(1, tree)
    with pytest.raises(ValueError, match="pass like="):
        mgr.restore(1)
    got, _ = mgr.restore(1, like=tree)
    np.testing.assert_array_equal(got["xs"][1], tree["xs"][1])


@pytest.mark.parametrize("preempt_after", [1, 3, 4, 5])
def test_snapshot_round_trip_resumes_bit_exact(tmp_path, preempt_after):
    """Snapshot mid-map, at the barrier, mid-reduce; restore template-free;
    resume: identical to the uninterrupted run."""
    _, job = _jobs()
    want = _outputs(job, run_resumable(job, CORPUS))
    state = run_resumable(job, CORPUS, preempt_after=preempt_after)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    step, save_s = save_snapshot(mgr, state)
    restored, got_step, restore_s = load_snapshot(mgr, device="cpu")
    assert got_step == step == state.cursor.waves_executed
    assert save_s >= 0.0 and restore_s >= 0.0
    assert restored.cursor == state.cursor
    for name, arr in state.arrays.items():
        assert restored.arrays[name].dtype == arr.dtype, name
        assert torch.equal(restored.arrays[name], arr), name
    _assert_same(_outputs(job, run_resumable(job, CORPUS, state=restored)), want)


@pytest.mark.parametrize("shuffle", SHUFFLES)
@pytest.mark.parametrize("preempt_after", [2, 4, 5])
def test_reference_snapshot_resumes_in_port_and_back(tmp_path, shuffle, preempt_after):
    """A snapshot the reference wrote resumes in the port (through
    ``snapshot_from_reference``), one the port wrote resumes in the
    reference (``snapshot_to_reference``); both end at the reference's
    uninterrupted result."""
    rjob, pjob = _jobs(shuffle_backend=shuffle)
    want = _outputs(rjob, rel.run_resumable(rjob, CORPUS))

    rmgr = rckpt.CheckpointManager(str(tmp_path / "ref"))
    rel.save_snapshot(rmgr, rel.run_resumable(rjob, CORPUS, preempt_after=preempt_after))
    tree, _ = CheckpointManager(str(tmp_path / "ref")).restore(None)
    state = pel.tree_to_state(snapshot_from_reference(tree), device="cpu")
    assert state.cursor.reduce_backend == "torch"
    _assert_same(_outputs(pjob, run_resumable(pjob, CORPUS, state=state)), want, "ref -> port")

    pmgr = CheckpointManager(str(tmp_path / "port"))
    save_snapshot(pmgr, run_resumable(pjob, CORPUS, preempt_after=preempt_after))
    tree, _ = rckpt.CheckpointManager(str(tmp_path / "port")).restore(None)
    state = rel.tree_to_state(snapshot_to_reference(tree))
    assert state.cursor.reduce_backend == "jnp"
    _assert_same(_outputs(rjob, rel.run_resumable(rjob, CORPUS, state=state)), want,
                 "port -> ref")


def test_snapshot_backend_name_must_be_known():
    tree = {"cursor": np.asarray(json.dumps({"reduce_backend": "mine"})), "arrays": {}}
    with pytest.raises(ValueError, match="unknown reduce backend"):
        snapshot_from_reference(tree)


# ------------------------------------------------ cursor and regrant model

def test_cursor_json_round_trip():
    _, job = _jobs()
    cur = run_resumable(job, CORPUS, preempt_after=4).cursor
    assert JobCursor.from_json(cur.to_json()) == cur


def test_cursor_json_equals_reference():
    rjob, pjob = _jobs(reduce_backend="xla")
    rcur = rel.run_resumable(rjob, CORPUS, preempt_after=4).cursor
    pcur = run_resumable(pjob, CORPUS, preempt_after=4).cursor
    assert json.loads(pcur.to_json()) == {**json.loads(rcur.to_json()),
                                          "reduce_backend": "scatter_reduce"}


def test_cursor_version_gate():
    _, job = _jobs()
    cur = job.initial_state().cursor
    bad = cur.to_json().replace('"_version": 1', '"_version": 99')
    with pytest.raises(ValueError, match="version"):
        JobCursor.from_json(bad)


def test_foreign_cursor_rejected():
    _, job_a = _jobs(num_mappers=5)
    _, job_b = _jobs(num_mappers=7)
    state = job_a.run(CORPUS, preempt_after=1)
    with pytest.raises(ValueError, match="does not match"):
        job_b.run(CORPUS, state=state)
    assert isinstance(state, ElasticState)


class TestRegrantCostModel:
    def test_remaining_fraction_requantizes(self):
        p = WorkProgress(mappers=16, reducers=8, map_tasks_done=8)
        assert p.steps_remaining(8) == 3
        assert p.steps_total(8) == 4
        assert p.steps_remaining(4) == 5
        assert p.steps_total(4) == 7
        assert 0 < p.remaining_fraction(8) < 1

    def test_grow_worth_it_when_gain_beats_overhead(self):
        cm = RegrantCostModel(snapshot_overhead_s=0.01, restore_overhead_s=0.01)
        p = WorkProgress(mappers=16, reducers=8)
        d = cm.evaluate(t_total_current=10.0, t_total_new=4.0, progress=p,
                        current_workers=2, new_workers=8)
        assert d.worth_it and d.gain_s > 0
        d2 = cm.evaluate(t_total_current=0.01, t_total_new=0.004, progress=p,
                         current_workers=2, new_workers=8)
        assert not d2.worth_it

    def test_shrink_gates(self):
        cm = RegrantCostModel(snapshot_overhead_s=0.01, restore_overhead_s=0.01,
                              min_remaining_frac=0.3, max_overhead_frac=0.25)
        nearly_done = WorkProgress(mappers=16, reducers=8, map_tasks_done=16,
                                   shuffled=True, reduce_tasks_done=7)
        d = cm.evaluate(t_total_current=10.0, t_total_new=12.0, progress=nearly_done,
                        current_workers=8, new_workers=2)
        assert not d.shrink_ok
        fresh = WorkProgress(mappers=16, reducers=8)
        d2 = cm.evaluate(t_total_current=10.0, t_total_new=12.0, progress=fresh,
                         current_workers=8, new_workers=2)
        assert d2.shrink_ok

    def test_measured_overhead_ewma(self):
        cm = RegrantCostModel(snapshot_overhead_s=0.1, restore_overhead_s=0.1,
                              ewma_alpha=0.5)
        cm.record_overhead(0.3, 0.5)
        assert cm.snapshot_overhead_s == pytest.approx(0.2)
        assert cm.restore_overhead_s == pytest.approx(0.3)
        assert cm.n_observed == 1

    def test_decisions_equal_the_reference(self):
        kw = dict(snapshot_overhead_s=0.05, restore_overhead_s=0.02,
                  min_remaining_frac=0.2)
        for progress in (dict(mappers=16, reducers=8, map_tasks_done=5),
                         dict(mappers=7, reducers=3, map_tasks_done=7, shuffled=True,
                              reduce_tasks_done=1, combine_steps=1, combined=True)):
            for cur, new in ((2, 8), (8, 2), (3, 3)):
                args = dict(t_total_current=4.0, t_total_new=2.5,
                            current_workers=cur, new_workers=new)
                got = RegrantCostModel(**kw).evaluate(progress=WorkProgress(**progress),
                                                      **args)
                want = rel.RegrantCostModel(**kw).evaluate(
                    progress=rel.WorkProgress(**progress), **args)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
