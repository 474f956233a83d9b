"""The engine's ``record_function`` ranges (``repro_torch.mapreduce.spans``)
on the CPU profiler.

Fused, pipelined (D = 2) and traced jobs of a small WordCount, combiner on
and off: every single-controller span appears, nested job > phase > wave >
step; the wave spans number the waves (the wave groups when pipelined);
the lexsort shuffle's three steps tile its span; outputs are bit-equal
with the profiler on and off; and with no profiler recording no range is
opened at all.  The all-to-all shuffle's pack / exchange / unpack lie
inside the shuffle on one controller, and on two gloo rank processes the
sharded mode's output all-gather (``mapreduce.gather``) lies outside it.
"""

import collections
import fcntl
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import repro_torch.mapreduce as port
from repro_torch.mapreduce import spans
from repro_torch.telemetry import SPANS, PhaseRecorder

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
CORPUS = port.wordcount_corpus(900, vocab_size=53, seed=9)
#: (M, R, W): 4 map and 3 reduce waves; 2 wave groups of each at D = 2
SHAPE = (7, 5, 2)
MODES = ("fused", "pipelined", "traced")
#: spans only a collective shuffle or the sharded mode opens
COLLECTIVE = {"mapreduce.shuffle.pack", "mapreduce.shuffle.exchange",
              "mapreduce.shuffle.unpack", "mapreduce.gather"}
#: spans only the lexsort shuffle's kernels open, on the card
CARD_ONLY = {"mapreduce.shuffle.split", "mapreduce.shuffle.merge"}
#: each span's parent span
PARENT = {
    "mapreduce.map": "mapreduce.job",
    "mapreduce.combine": "mapreduce.job",
    "mapreduce.shuffle": "mapreduce.job",
    "mapreduce.reduce": "mapreduce.job",
    "mapreduce.map.wave": "mapreduce.map",
    "mapreduce.map.spill_sort": "mapreduce.map.wave",
    "mapreduce.shuffle.sort": "mapreduce.shuffle",
    "mapreduce.shuffle.gather": "mapreduce.shuffle",
    "mapreduce.shuffle.scatter": "mapreduce.shuffle",
    "mapreduce.shuffle.split": "mapreduce.shuffle",
    "mapreduce.shuffle.merge": "mapreduce.shuffle",
    "mapreduce.shuffle.pack": "mapreduce.shuffle",
    "mapreduce.shuffle.exchange": "mapreduce.shuffle",
    "mapreduce.shuffle.unpack": "mapreduce.shuffle",
    "mapreduce.reduce.wave": "mapreduce.reduce",
}


def _plan(combiner, shuffle="lexsort"):
    M, R, W = SHAPE
    cfg = port.JobConfig(M, R, W, combiner=combiner, shuffle_backend=shuffle)
    return port.ExecutionPlan(port.wordcount(53), cfg, len(CORPUS), device="cpu")


def _job(plan, mode):
    if mode == "fused":
        return plan.fused()
    if mode == "pipelined":
        return plan.pipelined(depth=2)
    return plan.traced(PhaseRecorder())


def _profiled(job):
    """The job's outputs and its profile's ``mapreduce.*`` events."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = job(CORPUS)
    return out, [e for e in prof.events() if e.name.startswith("mapreduce.")]


def _span_parent(event):
    """The nearest enclosing ``mapreduce.*`` span, or None."""
    p = event.cpu_parent
    while p is not None and not p.name.startswith("mapreduce."):
        p = p.cpu_parent
    return p


@pytest.mark.parametrize("combiner", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_every_span_appears_nested_in_its_parent(mode, combiner):
    _, events = _profiled(_job(_plan(combiner), mode))
    want = set(SPANS) - COLLECTIVE - CARD_ONLY - (
        set() if combiner else {"mapreduce.combine"})
    assert {e.name for e in events} == want
    for e in events:
        parent = _span_parent(e)
        if e.name == "mapreduce.job":
            assert parent is None
        else:
            assert parent is not None and parent.name == PARENT[e.name], e.name
    shuffle_sort = next(e for e in events if e.name == "mapreduce.shuffle.sort")
    assert _span_parent(_span_parent(shuffle_sort)).name == "mapreduce.job"


@pytest.mark.parametrize("mode", MODES)
def test_wave_spans_number_the_waves(mode):
    plan = _plan(False)
    _, events = _profiled(_job(plan, mode))
    counts = collections.Counter(e.name for e in events)
    meta = plan.meta()
    if mode == "pipelined":  # one span a wave group of W * D tasks
        M, R, W = SHAPE
        waves = (-(-M // min(2 * W, M)), -(-R // min(2 * W, R)))
    else:
        waves = (meta["map_waves"], meta["reduce_waves"])
    assert (counts["mapreduce.map.wave"], counts["mapreduce.reduce.wave"]) == waves
    assert counts["mapreduce.map.spill_sort"] == waves[0]
    assert counts["mapreduce.job"] == 1


@pytest.mark.parametrize("combiner", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_lexsort_steps_tile_the_shuffle(mode, combiner):
    """Every host operation of the shuffle lies in one of its three steps,
    which run once each, in order."""
    _, events = _profiled(_job(_plan(combiner), mode))
    (shuffle,) = [e for e in events if e.name == "mapreduce.shuffle"]
    steps = sorted(shuffle.cpu_children, key=lambda e: e.time_range.start)
    assert [e.name for e in steps] == ["mapreduce.shuffle.sort",
                                       "mapreduce.shuffle.gather",
                                       "mapreduce.shuffle.scatter"]
    assert all(a.time_range.end <= b.time_range.start for a, b in zip(steps, steps[1:]))
    assert all(len(e.cpu_children) > 0 for e in steps)


@pytest.mark.parametrize("combiner", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_collective_shuffle_steps_lie_in_the_shuffle(mode, combiner):
    """The all-to-all shuffle on one controller: pack, the block transpose
    that stands for the exchange, and unpack, once each in the shuffle."""
    _, events = _profiled(_job(_plan(combiner, "all_to_all"), mode))
    counts = collections.Counter(e.name for e in events)
    for name in ("mapreduce.shuffle.pack", "mapreduce.shuffle.exchange",
                 "mapreduce.shuffle.unpack"):
        assert counts[name] == 1, name
        (e,) = [e for e in events if e.name == name]
        assert _span_parent(e).name == "mapreduce.shuffle"
    assert counts["mapreduce.gather"] == 0
    assert counts["mapreduce.shuffle.sort"] == 0


@pytest.mark.parametrize("shuffle", ["lexsort", "all_to_all"])
@pytest.mark.parametrize("combiner", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_outputs_bit_equal_with_the_profiler_on_and_off(mode, combiner, shuffle):
    job = _job(_plan(combiner, shuffle), mode)
    off = job(CORPUS)
    on, events = _profiled(job)
    assert events
    assert len(on) == len(off) == 3
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_no_range_is_opened_without_a_profiler(mode, monkeypatch):
    opened, real = [], torch.profiler.record_function

    def counting(name, args=None):
        opened.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    plan = _plan(True)
    job = _job(plan, mode)  # built with no profiler, as a benchmark builds
    job(CORPUS)
    assert opened == []
    assert spans.span("mapreduce.job") is spans.span("mapreduce.map")
    _, events = _profiled(job)
    names = [n for n, _ in opened]
    assert collections.Counter(names) == collections.Counter(e.name for e in events)
    # the args are strings made while the profiler records: the job's
    # setting, and each wave's index in order
    M, R, W = SHAPE
    assert [a for n, a in opened if n == "mapreduce.job"] == \
        [f"app=wordcount M={M} R={R} W={W}"]
    waves = [a for n, a in opened if n == "mapreduce.map.wave"]
    assert waves == [str(i) for i in range(len(waves))]
    assert all(a is None for n, a in opened if n == "mapreduce.shuffle")


def test_span_names_are_unique_and_of_the_engine():
    assert len(set(SPANS)) == len(SPANS)
    assert all(n.startswith("mapreduce.") for n in SPANS)
    assert set(PARENT) | {"mapreduce.job", "mapreduce.gather"} == set(SPANS)


# --------------------------------------------------------------- sharded

_RANK_SCRIPT = r"""
import datetime, sys
import torch
import torch.distributed as dist

sys.path.insert(0, sys.argv[3])
import repro_torch.mapreduce as port
from repro_torch.telemetry import PhaseRecorder

rank, init = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
corpus = port.wordcount_corpus(900, vocab_size=53, seed=9)


def ancestors(e):
    out = []
    while (e := e.cpu_parent) is not None:
        out.append(e.name)
    return out


for combiner in (False, True):
    cfg = port.JobConfig(5, 3, 2, combiner=combiner, shuffle_backend="all_to_all")
    plan = port.ExecutionPlan(port.wordcount(53), cfg, len(corpus), device="cpu")
    want = plan.fused()(corpus)
    for traced in (False, True):
        job = plan.sharded(recorder=PhaseRecorder() if traced else None)
        off = job(corpus)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            on = job(corpus)
        ctx = (combiner, traced)
        assert all(torch.equal(a, b) for a, b in zip(on, want)), ctx
        assert all(torch.equal(a, b) for a, b in zip(off, want)), ctx
        events = [e for e in prof.events() if e.name.startswith("mapreduce.")]
        names = {e.name for e in events}
        want_names = {"mapreduce.job", "mapreduce.map", "mapreduce.map.wave",
                      "mapreduce.map.spill_sort", "mapreduce.shuffle",
                      "mapreduce.shuffle.pack", "mapreduce.shuffle.exchange",
                      "mapreduce.shuffle.unpack", "mapreduce.reduce",
                      "mapreduce.reduce.wave", "mapreduce.gather"}
        if combiner:
            want_names.add("mapreduce.combine")
        assert names == want_names, (ctx, names ^ want_names)
        for e in events:
            up = ancestors(e)
            if e.name == "mapreduce.gather":
                assert "mapreduce.shuffle" not in up and "mapreduce.reduce" not in up, ctx
                assert up and up[-1] == "mapreduce.job", (ctx, up)
            if e.name.startswith("mapreduce.shuffle."):
                assert "mapreduce.shuffle" in up, (ctx, e.name, up)
            if e.name == "mapreduce.reduce.wave":
                assert "mapreduce.reduce" in up, (ctx, up)
        counts = [e.name for e in events]
        assert counts.count("mapreduce.map.wave") == cfg.map_waves, ctx
        assert counts.count("mapreduce.reduce.wave") == cfg.reduce_waves, ctx
        assert counts.count("mapreduce.gather") == 1, ctx
dist.barrier()
dist.destroy_process_group()
print(f"rank {rank}: spans ok", flush=True)
"""


@pytest.fixture
def rank_processes_alone(tmp_path_factory):
    """The lock the suite's gloo rank tests share (see
    ``test_torch_shuffle.py``), so no two of them compete for the cores."""
    with open(tmp_path_factory.getbasetemp().parent / "gloo_ranks.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def test_sharded_gather_is_split_from_the_exchange(tmp_path, rank_processes_alone):
    """Two gloo ranks at W = 2, fused and traced sharded jobs under the CPU
    profiler: the shuffle's pack, exchange and unpack inside
    ``mapreduce.shuffle``, the output all-gather in ``mapreduce.gather``
    outside it and outside the reduce, outputs equal to the emulated
    mode's with the profiler on and off."""
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    init = f"file://{tmp_path / 'pg'}"
    procs = [subprocess.Popen([sys.executable, str(script), str(r), init, str(SRC)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r}: spans ok" in out, out


def test_kernel_launch_range_is_an_operation_under_a_profiler():
    """``_build.launch_range`` is shared and empty with no profiler, and an
    operation (not a user range, which the profiler links no kernel to)
    named after the kernel while one records."""
    from repro_torch.kernels import _build

    assert _build.launch_range("segment_reduce") is _build.launch_range("wkv6")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("mapreduce.reduce.wave", 0), _build.launch_range("segment_reduce"):
            torch.ones(3).add_(1)
    (e,) = [e for e in prof.events() if e.name == "repro_torch::segment_reduce"]
    assert not e.is_user_annotation
    assert _span_parent(e).name == "mapreduce.reduce.wave"
    assert {c.name for c in e.cpu_children} >= {"aten::ones", "aten::add_"}
