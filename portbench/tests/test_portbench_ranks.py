"""Whole runs of the four-card cell's multi-rank runner on the CPU: gloo
ranks, each a process started with ``spawn``, at a tiny size.

``correct`` comes out true for the program as it is, at W = 2 and W = 4,
and false with one rank's part broken underneath: an output altered, a
pair dropped uncounted, a corpus that differs.  A rank that dies or hangs
mid-window fails the run with no result and leaves no process behind.
The reference's all-to-all layout is held against the program's emulated
mode and its gloo sharded mode with capacities so small that both the
send cut and the receive cut drop pairs.

A fault is a module-level function ``fault(rank, corpus)`` that each rank
calls once it has made its corpus; it patches the program in that rank's
own process only.
"""

import dataclasses
import multiprocessing as mp
import os
import time

import pytest

from portbench import harness, ranks
from portbench.reference import expected, mismatches, sent_pairs
from portbench.spec import Cell, load, load_cell

TOKENS = 1 << 13
SEED = 2**32 + 123
BROKEN_RANK = 1


def _cell(world, name="wc-a2a-w4", **common):
    """The four-card cell on ``world`` ranks, its mix's settings overridden
    by ``common``."""
    cell = load_cell(name)
    config = dict(cell.config, job=dict(cell.config["job"], workers=world))
    traffic = dict(cell.traffic, common=dict(cell.traffic["common"], **common))
    return dataclasses.replace(cell, chips=world, config=config, traffic=traffic)


def _run(cell, fault=None, seconds=0.4, trace=False, **kw):
    return ranks.run_ranks(cell, SEED, seconds, trace, time.time(), device="cpu",
                           tokens=TOKENS, hook=fault, **kw)


def _no_rank_left():
    return mp.active_children() == []


# ---------------------------------------------------------------- faults


def an_output_altered(rank, corpus):
    if rank != BROKEN_RANK:
        return
    from repro_torch.mapreduce.backends import CudaReduceBackend
    from repro_torch.mapreduce.phases import PAD_KEY

    reduce = CudaReduceBackend.reduce

    def broken(self, keys, values, op):
        ok, ov = reduce(self, keys, values, op)
        live = (ok != PAD_KEY).reshape(-1).nonzero()
        ov = ov.clone()
        if len(live):
            ov.view(-1)[live[0]] += 1
        return ok, ov

    CudaReduceBackend.reduce = broken


def a_pair_dropped_uncounted(rank, corpus):
    if rank != BROKEN_RANK:
        return
    from repro_torch.mapreduce import backends

    scatter = backends.bucket_scatter

    def broken(ids, n_buckets, n_rows, cap, arrays, fills):
        outs, dropped = scatter(ids, n_buckets, n_rows, cap, arrays, fills)
        live = (outs[0] != fills[0]).reshape(-1).nonzero()
        if len(live):
            for out, fill in zip(outs, fills):
                out.reshape(-1)[live[-1]] = fill
        return outs, dropped

    backends.bucket_scatter = broken


def a_corpus_that_differs(rank, corpus):
    if rank == BROKEN_RANK:
        corpus[:64] = (corpus[:64] + 1) % 4096


def _exit_in_the_window(rank, corpus):
    """Rank 1 ends its process in the exchange of its fifth job: after
    the two warm-up jobs, inside the window."""
    if rank != BROKEN_RANK:
        return
    from repro_torch.mapreduce.backends import AllToAllShuffle

    exchange, calls = AllToAllShuffle.exchange, [0]

    def broken(self, *args):
        calls[0] += 1
        if calls[0] == 5:
            os._exit(3)
        return exchange(self, *args)

    AllToAllShuffle.exchange = broken


def _hang_in_the_window(rank, corpus):
    if rank != BROKEN_RANK:
        return
    from repro_torch.mapreduce.backends import AllToAllShuffle

    exchange, calls = AllToAllShuffle.exchange, [0]

    def broken(self, *args):
        calls[0] += 1
        if calls[0] == 5:
            time.sleep(3600)
        return exchange(self, *args)

    AllToAllShuffle.exchange = broken


# ---------------------------------------------------------------- tests


@pytest.mark.parametrize("world", [2, 4])
def test_a_sound_run_is_correct(world):
    cell = _cell(world)
    line, log = _run(cell)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 3
    assert line["checks"] == {k: {"value": 0, "limit": 0} for k in
                              ("mismatched_slots", "rank_dropped_differing",
                               "corpus_ranks_differing")}
    assert list(line)[-1] == "checks"
    assert log[-3:] == ["check mismatched_slots 0 limit 0",
                        "check rank_dropped_differing 0 limit 0",
                        "check corpus_ranks_differing 0 limit 0"]
    assert line["device"]["count"] == world
    want = {m["name"] for m in harness.metrics_for(cell, trace=False)}
    assert set(line["metrics"]) == want and "setup_s" in want and len(want) >= 2
    # the corpus once a job, not once a rank
    rate = line["metrics"][next(n for n in want if n.startswith("tokens_per_s"))]
    p95 = line["metrics"][next(n for n in want if n.startswith("job_ms_p95"))]
    assert rate["value"] < TOKENS / (p95["value"] / 1e3) * 3
    assert _no_rank_left()


@pytest.mark.parametrize("fault", [an_output_altered, a_pair_dropped_uncounted,
                                   a_corpus_that_differs], ids=lambda f: f.__name__)
def test_a_fault_on_one_rank_is_not_correct(fault):
    line, log = _run(_cell(2), fault)
    assert line["correct"] is False
    assert line["checks"]["mismatched_slots"]["value"] > 0 or \
        line["checks"]["corpus_ranks_differing"]["value"] > 0
    if fault is a_corpus_that_differs:
        assert line["checks"]["corpus_ranks_differing"]["value"] == 1
    else:
        assert line["failed"] >= 1
    assert _no_rank_left()


def test_a_rank_that_exits_mid_window_fails_the_run():
    t0 = time.monotonic()
    with pytest.raises(ranks.RankFailure, match="rank 1 of 4 ended with exit code 3"):
        _run(_cell(4), _exit_in_the_window, seconds=30.0)
    assert time.monotonic() - t0 < 30.0  # found at once, not at the window's end
    assert _no_rank_left()


def test_a_rank_that_hangs_fails_the_run_within_its_margin():
    t0 = time.monotonic()
    with pytest.raises(ranks.RankFailure, match="did not answer in time"):
        _run(_cell(2), _hang_in_the_window, seconds=0.4, margin=20.0)
    assert time.monotonic() - t0 < 60.0
    assert _no_rank_left()


def test_the_command_gives_no_result_when_a_rank_dies(monkeypatch, capsys):
    """``run.py`` on a machine that seems to hold four cards, its ranks on
    the CPU with rank 1 dying in the window: an exit code other than 0 and
    nothing on standard output."""
    import torch

    from portbench import run

    real = ranks.run_ranks

    def on_the_cpu(cell, seed, seconds, trace, t_start):
        return real(cell, seed, seconds, trace, t_start, device="cpu", tokens=TOKENS,
                    hook=_exit_in_the_window)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(ranks, "run_ranks", on_the_cpu)
    code = run.main(["--workload", "wc-a2a-w4", "--seed", str(SEED), "--seconds", "30",
                     "--trace", "0"])
    out, err = capsys.readouterr()
    assert code != 0 and out == ""
    assert "rank 1 of 4 ended with exit code 3" in err
    assert _no_rank_left()


def test_a_traced_run_reports_the_cells_layers():
    cell = _cell(2)
    line, _ = _run(cell, trace=True)
    assert line["correct"] is True
    # on the CPU the device's times have nothing to read and are left out
    layer = {m["name"]: m for m in harness.metrics_for(cell, trace=True)}
    assert "shuffle.pack_ms" in layer and "exchange.nvlink_pct" in layer
    host = {n for n, m in layer.items() if m["source"] != "device_trace"
            and harness.base_name(n) not in ranks.spans.DEVICE_MS}
    assert set(line["metrics"]) == host and host
    assert line["device"]["count"] == 2 and line["device"]["window_s"] > 0
    assert 0 <= line["device"]["busy_s"] <= line["device"]["window_s"]
    assert {"device_ops", "idle_gaps"} == set(line["breakdown"])


def _a2a_shape(cell, n, world, factor, combiner):
    job = dataclasses.replace(cell.jobs()[0], mappers=9, reducers=5, workers=world,
                              capacity_factor=factor, combiner=combiner,
                              shuffle_backend="all_to_all", reduce_backend="torch")
    return job, cell.shape(job, n)


@pytest.mark.parametrize("world,factor,combiner", [(4, 0.2, False), (3, 0.1, False),
                                                   (2, 0.1, True), (3, 0.05, True)])
@pytest.mark.parametrize("name", ["wc-fixed", "exim-sweep"])
def test_the_reference_equals_the_emulated_all_to_all(name, world, factor, combiner):
    from portbench import gen
    from repro_torch.mapreduce import ExecutionPlan

    cell = load_cell(name)
    n = 20011
    corpus = gen.corpus(cell.config, SEED, "cpu", n)
    job, shape = _a2a_shape(cell, n, world, factor, combiner)
    out = ExecutionPlan(cell.app(n), job.job_config(), n, device="cpu").fused()(corpus)
    want = expected(corpus, shape)
    assert int(out[2]) == want.dropped
    assert mismatches(want, harness.read_output(out)) == 0
    _assert_both_cuts_drop(corpus, shape, want)


def _assert_both_cuts_drop(corpus, shape, want):
    from portbench.reference import mapreduce as ref

    made = int(ref._units(corpus, shape)[3].sum())
    send_dropped = made - int(sent_pairs(corpus, shape).sum())
    assert send_dropped > 0 and want.dropped - send_dropped > 0


@pytest.mark.parametrize("config,factor", [("wordcount-2p28", 0.2),
                                           ("exim-2p28", 0.2)])
def test_the_reference_equals_the_gloo_sharded_mode(config, factor):
    """The runner's own check, which holds rank 0's output slot for slot
    and every rank's ``dropped`` against the reference, over jobs whose
    send and receive capacities both drop pairs."""
    from portbench import gen

    cell = Cell(name=f"{config}-a2a", config=load("configs", config),
                traffic=load("traffic", "a2a"), chips=2)
    cell = dataclasses.replace(cell, config=dict(cell.config, job=dict(
        cell.config["job"], workers=2, mappers=9, reducers=5)))
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, common=dict(
        cell.traffic["common"], capacity_factor=factor)))
    line, _ = _run(cell)
    assert line["correct"] is True and line["failed"] == 0
    corpus = gen.corpus(cell.config, SEED, "cpu", TOKENS)
    shape = cell.shape(cell.jobs()[0], TOKENS)
    _assert_both_cuts_drop(corpus, shape, expected(corpus, shape))


def test_exchange_bytes_count_what_rank_0_sends_the_others():
    from portbench import gen

    cell = _cell(4)
    corpus = gen.corpus(cell.config, SEED, "cpu", TOKENS)
    shape = cell.shape(cell.jobs()[0], TOKENS)
    sent = sent_pairs(corpus, shape)
    # no capacity cut at factor 4: every pair of rank 0's tasks is sent
    assert sent.sum() == TOKENS and sent.shape == (4, 4)
    assert ranks.exchange_bytes(cell, cell.jobs(), corpus, TOKENS) == \
        8.0 * (sent[0].sum() - sent[0, 0])


def test_the_checksum_sees_one_token_changed():
    import torch

    x = torch.arange(3 * ranks.CHUNK // 2, dtype=torch.int32) % 4099
    a = ranks.checksum(x)
    y = x.clone()
    y[ranks.CHUNK + 5] += 1
    y[ranks.CHUNK + 6] -= 1
    assert ranks.checksum(x) == a and ranks.checksum(y) != a
    assert a[0] == int(x.to(torch.int64).sum())


def test_result_lines_name_their_metrics():
    """A ``.w<N>`` metric reads the quantity of its base name."""
    assert harness.base_name("tokens_per_s.w4") == "tokens_per_s"
    assert harness.base_name("phase.map_ms.w16") == "phase.map_ms"
    assert harness.base_name("phase.map_ms") == "phase.map_ms"
    assert harness.base_name("exchange.nvlink_pct") == "exchange.nvlink_pct"
    assert harness.reader_path("phase.map_ms.w4") == harness.reader_path("phase.map_ms")
    assert harness.reader_path("phase.map_ms.w4").is_file()
    assert harness.read_layer("phase.map_ms.w4", {}) is None
