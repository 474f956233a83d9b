"""The reduce wave: one backend call per wave that reduces its real rows
straight into the output rows (``phases.reduce_wave``), against the
composition it replaced, and the modes that run it against each other.

The replaced composition, rebuilt here as it ran: each wave a W-row window
of the partitions, padded to W rows with PAD rows and clamped back onto
rows already done at the end, reduced by the plain segment reduce, each
task's startup (seeded by its row's key sum) added to the live slots in
float32, and the window's real rows copied into the outputs.  Everything
runs on the CPU (the kernels' plain versions); nothing here imports JAX.
"""

import datetime
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.mapreduce as port
from repro_torch.kernels.segment_reduce import (
    PAD_KEY,
    row_key_sums,
    segment_reduce,
    segment_reduce_ref,
)
from repro_torch.mapreduce import phases
from repro_torch.mapreduce.backends import get_reduce_backend
from repro_torch.telemetry import PhaseRecorder


def _old_reduce_phase(cfg, pk, pv, W):
    """The replaced reduce phase: padded, clamped W-row windows, the plain
    reduce, the startup added in float32 to live slots, then the commit
    copy of the window's real rows."""
    R, cap = pk.shape
    pad = max(0, W - R)
    kp = torch.cat([pk, torch.full((pad, cap), PAD_KEY, dtype=pk.dtype)])
    vp = torch.cat([pv, torch.zeros((pad, cap), dtype=pv.dtype)])
    ok_buf, ov_buf = torch.empty_like(pk), torch.empty_like(pv)
    for i in range(math.ceil(R / W)):
        s = max(0, min(i * W, R + pad - W))
        kblk, vblk = kp[s:s + W], vp[s:s + W]
        ok, ov = segment_reduce_ref(kblk, vblk)
        setup = phases.task_setup(cfg.setup_dim, cfg.setup_rounds, kblk.sum(dim=1))
        ov = ov + torch.where(ok != PAD_KEY, setup[:, None], 0.0).to(ov.dtype)
        n = min(W, R - s)
        ok_buf[s:s + n], ov_buf[s:s + n] = ok[:n], ov[:n]
    return ok_buf, ov_buf


def _partitions(R, cap, seed):
    """(R, cap) key-sorted, PAD-tailed partitions with one of each edge: an
    all-PAD row, a row with no PAD, a run ending at the row's last slot,
    one key filling a row, and random quarter-to-full rows (negative keys
    and values near the int32 limits, so sums wrap)."""
    rng = np.random.default_rng(seed)
    keys = np.full((R, cap), PAD_KEY, dtype=np.int64)
    vals = rng.integers(-(2**31), 2**31 - 1, size=(R, cap))
    for r in range(R):
        live = int(rng.integers(cap // 4, cap + 1))
        keys[r, :live] = np.sort(rng.integers(-50, 50, size=live))
    keys[0] = PAD_KEY                                   # all PAD
    if R > 1:
        keys[1] = np.sort(rng.integers(0, 7, size=cap))  # no PAD; last run ends at the end
    if R > 2:
        keys[2] = 9                                     # one key fills the row
    return (torch.from_numpy(keys.astype(np.int32)),
            torch.from_numpy(vals.astype(np.int32)))


@pytest.mark.parametrize("backend", ["cuda", "torch", "scatter_reduce"])
@pytest.mark.parametrize("R,W", [(3, 8), (7, 3), (5, 5), (17, 8), (1, 1), (7, 8)],
                         ids=["R<W", "partial-last-wave", "R=W", "R>2W", "one", "wc-fixed"])
def test_reduce_phase_equals_the_replaced_composition(backend, R, W):
    """The plan's reduce phase (one ``reduce_wave`` a wave of the real rows)
    equals the padded, clamped, copied composition bit for bit, with one
    backend call a wave."""
    cfg = port.JobConfig(4, R, W, reduce_backend=backend)
    plan = port.ExecutionPlan(port.wordcount(64), cfg, 4096, device="cpu")
    pk, pv = _partitions(R, 301, seed=R * 10 + W)
    want = _old_reduce_phase(cfg, pk, pv, W)
    got = plan._reduce_phase_fn(W)(pk, pv)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("R,W", [(3, 8), (7, 3), (17, 8)])
def test_reduce_stepper_writes_only_its_rows(R, W):
    """A stepper call at ``start`` writes rows [start, min(start + W, R))
    and no other; the steps together give the phase's outputs."""
    cfg = port.JobConfig(4, R, W, reduce_backend="cuda")
    plan = port.ExecutionPlan(port.wordcount(64), cfg, 4096, device="cpu")
    pk, pv = _partitions(R, 97, seed=R + W)
    step = plan.reduce_stepper(W, 97)
    ok, ov = plan.initial_reduce_buffers(97)
    for start in range(0, R, W):
        before = ok.clone(), ov.clone()
        ok, ov = step(pk, pv, ok, ov, start)
        rows = torch.zeros(R, dtype=torch.bool)
        rows[start:start + W] = True
        assert torch.equal(ok[~rows], before[0][~rows])
        assert torch.equal(ov[~rows], before[1][~rows])
    assert all(torch.equal(g, w) for g, w in zip((ok, ov), _old_reduce_phase(cfg, pk, pv, W)))


def test_reduce_local_equals_the_plan_phase():
    """The sharded mode's ``reduce_local`` (one one-task wave a slot) equals
    the plan's reduce phase on the same partitions."""
    cfg = port.JobConfig(4, 6, 2, reduce_backend="cuda")
    plan = port.ExecutionPlan(port.wordcount(64), cfg, 4096, device="cpu")
    pk, pv = _partitions(6, 211, seed=3)
    got = phases.reduce_local(plan.app, cfg, pk, pv, plan.reduce_backend)
    want = plan._reduce_phase_fn(2)(pk, pv)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_plain_segment_reduce_adds_the_addend_at_run_heads():
    """The plain version's addend, and the CPU wrapper's ``out`` rows,
    equal the reduce followed by the masked add the wave used to make."""
    pk, pv = _partitions(5, 77, seed=11)
    addend = torch.tensor([3, -2**31, 2**31 - 1, 0, 17], dtype=torch.int32)
    ok, ov = segment_reduce_ref(pk, pv)
    want = ov + torch.where(ok != PAD_KEY, addend[:, None], 0)
    assert torch.equal(segment_reduce_ref(pk, pv, addend)[1], want)
    out = torch.full((7, 77), -1, dtype=torch.int32), torch.full((7, 77), -1, dtype=torch.int32)
    got = segment_reduce(pk, pv, out=(out[0][1:6], out[1][1:6]), addend=addend)
    assert got[0].data_ptr() == out[0][1:6].data_ptr()
    assert torch.equal(out[0][1:6], ok) and torch.equal(out[1][1:6], want)
    assert (out[0][[0, 6]] == -1).all() and (out[1][[0, 6]] == -1).all()
    # a (C,) row takes a scalar addend
    k1, v1 = segment_reduce(pk[3], pv[3], addend=addend[4])
    assert torch.equal(k1, ok[3]) and torch.equal(v1, want[3] + torch.where(ok[3] != PAD_KEY, 17, 0))


def test_row_key_sums_is_the_exact_row_sum_on_the_cpu():
    pk, _ = _partitions(4, 1000, seed=5)
    assert torch.equal(row_key_sums(pk), pk.sum(dim=1))
    assert row_key_sums(pk).dtype == torch.int64


def test_meta_tensors_give_shapes_and_launch_nothing():
    """The cost estimator's shape-only pass: the wrapper with ``out`` rows
    and an addend, the key sums and a whole wave on meta tensors."""
    before = segment_reduce.launches, row_key_sums.launches
    k = torch.empty((3, 40), dtype=torch.int32, device="meta")
    out = torch.empty((5, 40), dtype=torch.int32, device="meta")
    addend = torch.empty(3, dtype=torch.int32, device="meta")
    ok, ov = segment_reduce(k, k, out=(out[1:4], out[1:4]), addend=addend)
    assert ok.shape == ov.shape == (3, 40) and ok.is_meta
    sums = row_key_sums(k)
    assert sums.shape == (3,) and sums.dtype == torch.int64 and sums.is_meta
    cfg = port.JobConfig(4, 3, 2, reduce_backend="cuda")
    phases.reduce_wave(cfg, get_reduce_backend("cuda"), "sum", k, k, out[1:4], out[1:4])
    assert (segment_reduce.launches, row_key_sums.launches) == before


# ------------------------------------------------------ the modes agree

_APPS = {
    "wordcount": (port.wordcount(512), port.wordcount_corpus(6000, 512, zipf_a=1.0, seed=2)),
    "exim": (port.eximparse(256), port.exim_mainlog(6000, 256, seed=2)),
}


@pytest.mark.parametrize("combiner", [False, True])
@pytest.mark.parametrize("app", sorted(_APPS))
@pytest.mark.parametrize("M,R,W", [(16, 7, 8), (7, 17, 4)])
def test_fused_traced_and_pipelined_jobs_agree(app, combiner, M, R, W):
    """Fused, traced (depths 1 and 2) and pipelined (depth 2) jobs with the
    ``cuda`` backend's plain versions, bit for bit, and equal to the
    ``torch`` backend's fused job."""
    mr, corpus = _APPS[app]
    corpus = torch.from_numpy(corpus)
    cfg = port.JobConfig(M, R, W, combiner=combiner, reduce_backend="cuda")
    plan = port.ExecutionPlan(mr, cfg, len(corpus), device="cpu")
    fused = plan.fused()(corpus)
    runs = {"pipelined": plan.pipelined(depth=2)(corpus)}
    for depth in (1, 2):
        runs[f"traced{depth}"] = plan.traced(PhaseRecorder(), depth=depth)(corpus)
    torch_cfg = port.JobConfig(M, R, W, combiner=combiner, reduce_backend="torch")
    runs["torch"] = port.ExecutionPlan(mr, torch_cfg, len(corpus), device="cpu").fused()(corpus)
    for name, got in runs.items():
        assert all(torch.equal(g, f) for g, f in zip(got, fused)), name


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo process group of one rank in this process (file:// init, so
    parallel test workers cannot collide on a port)."""
    path = tmp_path_factory.mktemp("pg") / "init"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("combiner", [False, True])
@pytest.mark.parametrize("app", sorted(_APPS))
def test_gloo_sharded_reduce_local_agrees_with_the_emulated_modes(world1, app, combiner):
    """The sharded mode on a gloo group of one rank (its reduce is
    ``reduce_local``, one wave a slot) against the emulated all-to-all
    fused and pipelined jobs at W = 1, fused and traced."""
    mr, corpus = _APPS[app]
    corpus = torch.from_numpy(corpus)
    cfg = port.JobConfig(5, 3, 1, combiner=combiner, reduce_backend="cuda",
                         shuffle_backend="all_to_all")
    plan = port.ExecutionPlan(mr, cfg, len(corpus), device="cpu")
    want = plan.fused()(corpus)
    assert all(torch.equal(g, w) for g, w in zip(plan.pipelined(depth=2)(corpus), want))
    got = plan.sharded(world1)(corpus)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    recorder = PhaseRecorder()
    got = plan.sharded(world1, recorder=recorder)(corpus)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert recorder.last.check_conservation() == []
