"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``; each test skips when no CUDA device is present.  This
file imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.local_reduce import local_reduce, local_reduce_ref
from repro_torch.kernels.rwkv6 import wkv6, wkv6_chunked_ref
from repro_torch.kernels.segment_reduce import (
    PAD_KEY,
    row_key_sums,
    segment_reduce,
    segment_reduce_ref,
)
from repro_torch.kernels.shuffle_merge import shuffle_merge
from repro_torch.mapreduce import (
    ExecutionPlan,
    JobConfig,
    build_job,
    get_shuffle_backend,
    wordcount,
    wordcount_corpus,
)
from repro_torch.mapreduce.backends import lexsort_partition
from repro_torch.mapreduce.phases import combine_rows, partition_capacity
from repro_torch.telemetry import PhaseRecorder

KERNELS = {
    "segment_reduce": (segment_reduce, segment_reduce_ref),
    "local_reduce": (local_reduce, local_reduce_ref),
}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _sorted_rows(rng, n_rows, n_cols, nkeys):
    keys = np.sort(rng.integers(0, nkeys, size=(n_rows, n_cols)), axis=1)
    for r in range(n_rows):
        npad = int(rng.integers(0, max(1, n_cols // 3)))
        if npad:
            keys[r, -npad:] = PAD_KEY
    vals = rng.integers(1, 4000, size=(n_rows, n_cols))
    return (torch.from_numpy(keys.astype(np.int32)).cuda(),
            torch.from_numpy(vals.astype(np.int32)).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("R,C,nkeys", [(3, 64, 10), (1, 100_003, 7),
                                       (5, 40_000, 4096), (2, 1, 3)])
def test_kernel_matches_plain(name, R, C, nkeys):
    _needs_card()
    kern, ref = KERNELS[name]
    k, v = _sorted_rows(np.random.default_rng(R * C), R, C, nkeys)
    before = kern.launches
    got, want = kern(k, v), ref(k, v)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take():
    _needs_card()
    k = torch.zeros((2, 8), dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="int32"):
        segment_reduce(k, k.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        local_reduce(k.t(), k.t())


def _wave_rows(C):
    """Seven (7, C) sorted, PAD_KEY-tailed rows, one of each edge the
    kernel's tiles meet: random runs over a quarter-live row, an all-PAD
    row, a row with no PAD (runs of about C / 10 slots, across many tiles),
    one key filling the row (a run ending at the row's last slot), runs
    ending on 4096-slot tile edges, values near the int32 limits (sums that
    wrap), and a row of runs of 1000 with no PAD."""
    rng = np.random.default_rng(C)
    keys = np.full((7, C), PAD_KEY, dtype=np.int64)
    vals = rng.integers(1, 4000, size=(7, C))
    live = C // 4
    keys[0, :live] = np.sort(rng.integers(-5000, 5000, size=live))
    keys[2] = np.sort(rng.integers(0, 10, size=C))
    keys[3] = 42
    keys[4, :C // 2] = np.arange(C // 2) // 4096
    keys[5, :live] = np.sort(rng.integers(0, 50, size=live))
    vals[5] = rng.integers(2**31 - 2**20, 2**31 - 1, size=C)
    keys[6] = np.arange(C) // 1000
    return (torch.from_numpy(keys.astype(np.int32)).cuda(),
            torch.from_numpy(vals.astype(np.int32)).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1 << 22, 9001])
def test_segment_reduce_writes_output_rows_with_an_addend(C):
    """The kernel as a reduce wave calls it: one launch writes rows [s, s + 7)
    of larger (12, C) outputs holding garbage, each run's sum plus its row's
    addend (sums that wrap included) at its head, bit for bit as the plain
    version; the rows around them keep their contents."""
    _needs_card()
    k, v = _wave_rows(C)
    addend = torch.tensor([0, 5, -7, 2**31 - 1, -(2**31), 123456, 1], dtype=torch.int32,
                          device="cuda")
    want = segment_reduce_ref(k, v, addend)
    ok = torch.full((12, C), -1, dtype=torch.int32, device="cuda")
    ov = torch.full((12, C), -3, dtype=torch.int32, device="cuda")
    before = segment_reduce.launches
    got = segment_reduce(k, v, out=(ok[3:10], ov[3:10]), addend=addend)
    torch.cuda.synchronize()
    assert segment_reduce.launches == before + 1
    assert got[0].data_ptr() == ok[3:10].data_ptr()
    assert torch.equal(ok[3:10], want[0]) and torch.equal(ov[3:10], want[1])
    assert (ok[:3] == -1).all() and (ok[10:] == -1).all()
    assert (ov[:3] == -3).all() and (ov[10:] == -3).all()
    # no addend: the plain reduce, into the same rows again
    segment_reduce(k, v, out=(ok[3:10], ov[3:10]))
    want = segment_reduce_ref(k, v)
    assert torch.equal(ok[3:10], want[0]) and torch.equal(ov[3:10], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1 << 22, 9001, 4096, 4097, 1])
def test_row_key_sums_equal_the_full_row_sum(C):
    """The wave's key sums, read from the live prefix only, equal
    ``keys.sum(dim=1)`` over the whole rows: an all-PAD row, rows with no
    PAD, a PAD tail starting on a tile edge and inside a tile; 7 rows and
    40 (fewer blocks a row)."""
    _needs_card()
    k, _ = _wave_rows(C)
    before = row_key_sums.launches
    assert torch.equal(row_key_sums(k), k.sum(dim=1))
    assert row_key_sums.launches == before + 1
    many = k.repeat(6, 1)[:40].clone()
    for r in range(0, 40, 3):  # tails from tile edges and from inside tiles
        many[r, min(C, 4096 * (r // 3)) + r % 2:] = PAD_KEY
        many[r] = torch.sort(many[r]).values
    assert torch.equal(row_key_sums(many), many.sum(dim=1))


@pytest.mark.cuda
def test_segment_reduce_refuses_outputs_and_addends_it_cannot_take():
    _needs_card()
    k = torch.zeros((2, 8), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="out must be"):
        segment_reduce(k, k, out=(torch.empty((3, 8), dtype=torch.int32, device="cuda"),) * 2)
    with pytest.raises(ValueError, match="contiguous"):
        segment_reduce(k, k, out=(torch.empty((8, 2), dtype=torch.int32, device="cuda").t(),) * 2)
    with pytest.raises(ValueError, match="addend"):
        segment_reduce(k, k, addend=torch.zeros(3, dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError, match="addend"):
        segment_reduce(k, k, addend=torch.zeros(2, dtype=torch.int64, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("combiner", [False, True])
@pytest.mark.parametrize("app", ["wordcount", "exim"])
def test_job_on_card_equals_cpu(app, combiner):
    """A (16, 7, 8) job, reduce backend ``cuda``, on the card and on the CPU
    (the kernels' plain versions): the same outputs bit for bit, one
    ``segment_reduce`` and one ``row_key_sums`` launch for its one reduce
    wave."""
    _needs_card()
    from repro_torch.mapreduce import eximparse, exim_mainlog

    if app == "wordcount":
        mr, corpus = wordcount(5000), wordcount_corpus(400_000, 5000, zipf_a=1.0, seed=5)
    else:
        mr, corpus = eximparse(4096), exim_mainlog(400_002, 4096, seed=5)
    cfg = JobConfig(16, 7, 8, combiner=combiner, reduce_backend="cuda")
    want = build_job(mr, cfg, len(corpus), device="cpu")(torch.from_numpy(corpus))
    seg, sums = segment_reduce.launches, row_key_sums.launches
    got = build_job(mr, cfg, len(corpus), device="cuda")(torch.from_numpy(corpus).cuda())
    torch.cuda.synchronize()
    assert (segment_reduce.launches - seg, row_key_sums.launches - sums) == (1, 1)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def _spill_sorted_rows(rng, M, C, hot=None):
    """(M, C) task rows as the map's stable spill sort leaves them: about
    70 % valid pairs, keys drawn from a small key space, negative keys,
    INT32_MIN and valid INT32_MAX keys (which sort among the invalid tail
    pairs); ``hot``: every key that one value instead."""
    keys = rng.integers(-2000, 2000, size=(M, C))
    special = rng.random((M, C))
    keys[special < 0.02] = -(2**31)
    keys[(special >= 0.02) & (special < 0.04)] = PAD_KEY
    keys[(special >= 0.04) & (special < 0.06)] = rng.integers(-(2**31), 2**31 - 1)
    if hot is not None:
        keys[:] = hot
    valid = rng.random((M, C)) < 0.7
    vals = rng.integers(-(2**31), 2**31 - 1, size=(M, C))
    keys, vals, valid = (torch.from_numpy(a).cuda() for a in (
        keys.astype(np.int32), vals.astype(np.int32), valid))
    _, order = torch.sort(torch.where(valid, keys, PAD_KEY), dim=1, stable=True)
    return keys.gather(1, order), vals.gather(1, order), valid.gather(1, order)


def _assert_shuffle_merge_matches_plain(k, v, p, R, cap, n_rows=None):
    before = shuffle_merge.launches
    got = shuffle_merge(k, v, p, R, cap, n_rows)
    want = lexsort_partition(k, v, p, R, cap, n_rows)
    torch.cuda.synchronize()
    assert shuffle_merge.launches == before + 1
    assert got[0].shape == want[0].shape and got[2].shape == want[2].shape == ()
    assert got[2].dtype == want[2].dtype == torch.int32
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 5, 7, 28, 40])
@pytest.mark.parametrize("M", [1, 2, 5, 16, 17, 40])
def test_shuffle_merge_matches_plain(M, R):
    """Spill-sorted task rows of 9001 slots (three split tiles, the last
    ragged) at every (M, R): keys, values and ``dropped`` bit for bit."""
    _needs_card()
    k, v, p = _spill_sorted_rows(np.random.default_rng(M * 100 + R), M, 9001)
    _assert_shuffle_merge_matches_plain(k, v, p, R, partition_capacity(M * 9001, R, 4.0))


@pytest.mark.cuda
@pytest.mark.parametrize("M,R,factor", [(16, 7, 4.0), (5, 40, 1.0), (17, 5, 0.5), (1, 7, 4.0)])
def test_shuffle_merge_cuts_a_hot_key_at_capacity(M, R, factor):
    """One key for every pair: its partition overflows, and the kernel cuts
    the same pairs as the plain version and counts them."""
    _needs_card()
    k, v, p = _spill_sorted_rows(np.random.default_rng(M + R), M, 20_000, hot=-12345)
    cap = partition_capacity(M * 20_000, R, factor)
    _, _, dropped = _assert_shuffle_merge_matches_plain(k, v, p, R, cap)
    assert int(dropped) == int(p.sum()) - cap > 0


@pytest.mark.cuda
@pytest.mark.parametrize("M,R,n_rows", [(7, 3, 4), (16, 7, 8), (40, 40, 40)])
def test_shuffle_merge_on_combined_column_slices(M, R, n_rows):
    """Rows the combiner leaves: ``local_reduce``'s front-packed rows cut to
    the combine width, column slices with a row stride wider than the row,
    which the kernel reads in place; partitions padded to ``n_rows``."""
    _needs_card()
    rng = np.random.default_rng(M * R)
    k, v, p = _spill_sorted_rows(rng, M, 30_000)
    from repro_torch.mapreduce.backends import get_reduce_backend

    ck, cv, cvalid = combine_rows(get_reduce_backend("cuda"), k, v, p, "sum", 5000)
    assert ck.stride(0) == 30_000 and not ck.is_contiguous()
    cap = partition_capacity(ck.numel(), R, 4.0)
    _assert_shuffle_merge_matches_plain(ck, cv, cvalid, R, cap, n_rows)


@pytest.mark.cuda
def test_shuffle_merge_refuses_what_the_kernel_does_not_take():
    _needs_card()
    k = torch.zeros((4, 8), dtype=torch.int32, device="cuda")
    p = torch.ones((4, 8), dtype=torch.bool, device="cuda")
    with pytest.raises(TypeError, match="int32"):
        shuffle_merge(k.to(torch.int64), k, p, 3, 16)
    with pytest.raises(TypeError, match="bool"):
        shuffle_merge(k, k, p.to(torch.int32), 3, 16)
    with pytest.raises(ValueError, match="shape"):
        shuffle_merge(k[None], k[None], p[None], 3, 16)
    with pytest.raises(ValueError, match="shape"):
        shuffle_merge(k, k[:, :4], p, 3, 16)
    with pytest.raises(ValueError, match="contiguous"):
        shuffle_merge(k.t(), k.t(), p.t(), 3, 16)
    with pytest.raises(ValueError, match="shape"):  # one flat stream
        shuffle_merge(k.reshape(-1), k.reshape(-1), p.reshape(-1), 3, 16)
    with pytest.raises(ValueError, match="shape"):
        get_shuffle_backend("lexsort").partition(
            JobConfig(4, 3, 1), k.reshape(-1), k.reshape(-1), p.reshape(-1))
    with pytest.raises(ValueError, match="one CUDA device"):
        shuffle_merge(k, k.cpu(), p, 3, 16)
    with pytest.raises(ValueError, match="one CUDA device"):
        shuffle_merge(k.cpu(), k.cpu(), p.cpu(), 3, 16)
    with pytest.raises(ValueError, match="empty"):
        shuffle_merge(k[:0], k[:0], p[:0], 3, 16)
    for R, n_rows in ((0, 3), (1024, 1024), (4, 3)):
        with pytest.raises(ValueError, match="reducers"):
            shuffle_merge(k, k, p, R, 16, n_rows)
    with pytest.raises(ValueError, match="capacity"):
        shuffle_merge(k, k, p, 3, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("combiner", [False, True])
def test_cuda_backend_equals_torch_backend(combiner):
    _needs_card()
    corpus = torch.from_numpy(wordcount_corpus(50_000, 500, seed=3)).cuda()
    outs = {}
    for backend in ("cuda", "torch"):
        cfg = JobConfig(7, 3, 2, combiner=combiner, reduce_backend=backend)
        before = shuffle_merge.launches
        outs[backend] = build_job(wordcount(500), cfg, len(corpus))(corpus)
        assert shuffle_merge.launches == before + 1  # one a lexsort job
    assert all(torch.equal(a, b) for a, b in zip(outs["cuda"], outs["torch"]))


@pytest.mark.cuda
@pytest.mark.parametrize("combiner", [False, True])
@pytest.mark.parametrize("M,R,W", [(7, 3, 2), (37, 40, 4)])
def test_pipelined_and_traced_jobs_equal_fused(combiner, M, R, W):
    """The pipelined mode at depths 1-3 and the traced mode at depths 1 and
    2, reduce backend ``cuda``: bit-exact against fused, one
    ``segment_reduce`` launch a wave group and one ``local_reduce`` a
    combiner job; the traces conserve."""
    _needs_card()
    corpus = torch.from_numpy(wordcount_corpus(50_000, 500, seed=3)).cuda()
    cfg = JobConfig(M, R, W, combiner=combiner, reduce_backend="cuda")
    plan = ExecutionPlan(wordcount(500), cfg, len(corpus))
    fused = plan.fused()(corpus)
    for depth in (1, 2, 3):
        seg, loc, shuf = segment_reduce.launches, local_reduce.launches, shuffle_merge.launches
        got = plan.pipelined(depth=depth)(corpus)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, fused)), depth
        assert segment_reduce.launches - seg == -(-R // min(W * depth, R))
        assert local_reduce.launches - loc == int(combiner)
        assert shuffle_merge.launches - shuf == 1
    recorder = PhaseRecorder()
    for depth in (1, 2):
        shuf = shuffle_merge.launches
        got = plan.traced(recorder, depth=depth)(corpus)
        assert shuffle_merge.launches - shuf == 1
        assert all(torch.equal(a, b) for a, b in zip(got, fused)), depth
        trace = recorder.last
        assert trace.check_conservation() == []
        assert trace.counter("map", "pairs_emitted") == len(corpus)
        assert ("pipeline" in trace.phase_names()) == (depth > 1)


@pytest.mark.cuda
@pytest.mark.parametrize("combiner", [False, True])
def test_sharded_nccl_world1_equals_emulated(tmp_path, combiner):
    """The sharded mode on an NCCL group of one rank (one card) against the
    emulated all-to-all at W = 1, reduce backend ``cuda``: bit-exact, one
    ``segment_reduce`` launch a reduce slot (R at W = 1)."""
    _needs_card()
    import datetime

    import torch.distributed as dist

    corpus = torch.from_numpy(wordcount_corpus(50_000, 500, seed=3)).cuda()
    cfg = JobConfig(5, 3, 1, combiner=combiner, reduce_backend="cuda",
                    shuffle_backend="all_to_all")
    plan = ExecutionPlan(wordcount(500), cfg, len(corpus))
    want = plan.fused()(corpus)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        seg = segment_reduce.launches
        ok, ov, dropped, stats = plan.sharded(counters=True)(corpus)
        torch.cuda.synchronize()
        assert segment_reduce.launches - seg == 3
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(a, b) for a, b in zip((ok, ov, dropped), want))
    assert stats["dropped_per_worker"].shape == (1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("shuffle", ["lexsort", "all_to_all"])
@pytest.mark.parametrize("combiner", [False, True])
def test_resumable_on_card_equals_fused(shuffle, combiner):
    """A resumable job on the card, preempted at every boundary and
    resumed, equal to fused; one ``segment_reduce`` a reduce step."""
    _needs_card()
    from repro_torch.elastic import run_resumable

    corpus = torch.from_numpy(wordcount_corpus(50_000, 500, seed=3)).cuda()
    cfg = JobConfig(7, 3, 2, combiner=combiner, reduce_backend="cuda",
                    shuffle_backend=shuffle)
    plan = ExecutionPlan(wordcount(500), cfg, len(corpus))
    fused = plan.fused()(corpus)
    job = plan.resumable()
    total = run_resumable(job, corpus).cursor.waves_executed
    for k in range(1, total):
        part = run_resumable(job, corpus, preempt_after=k)
        seg = segment_reduce.launches
        state = run_resumable(job, corpus, state=part)
        assert segment_reduce.launches - seg == 2 - max(0, k - (total - 2))
        assert all(torch.equal(a, b) for a, b in zip(job.result(state), fused)), k


@pytest.mark.cuda
def test_engine_oracle_cuda_job_on_card():
    """The cluster layer's engine oracle runs ``cuda``-backend jobs on the
    card: traced, conserving, one ``segment_reduce`` a reduce wave and one
    ``local_reduce`` a combiner job, for the warmup and the timed run."""
    _needs_card()
    from repro_torch.cluster import Cluster, EngineOracle, JobSpec, get_policy

    oracle = EngineOracle(traced=True, device="cuda")
    seg, loc = segment_reduce.launches, local_reduce.launches
    res = Cluster(4, oracle).run(
        [JobSpec(job_id=0, app="wordcount", size=1 << 16, arrival=0.0)],
        get_policy("fifo-static", mappers=7, reducers=5, workers=2,
                   backend="cuda"))
    rec, = res.records
    assert rec.completed and rec.true_time > 0
    assert rec.trace.phase_names() == ["map", "shuffle", "reduce"]
    assert rec.trace.check_conservation() == []
    assert segment_reduce.launches - seg == 2 * 3  # ceil(5 / 2) a run
    oracle.time("wordcount", "cuda", 1 << 16, 7, 5, 2, combiner=True)
    trace = oracle.take_trace()
    assert trace.phase_names() == ["map", "combine", "shuffle", "reduce"]
    assert trace.check_conservation() == []
    assert segment_reduce.launches - seg == 4 * 3
    assert local_reduce.launches - loc == 2


ATTN_TOL ={torch.float32: 2e-5, torch.bfloat16: 5e-2}


def _attn_inputs(seed, dtype, *shapes):
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full float32
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=g, device="cuda").to(dtype) for s in shapes]


def _assert_close(got, want, dtype):
    tol = ATTN_TOL[dtype]
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,Hq,nkv,hd,causal", [
    (2, 128, 128, 4, 2, 64, True),
    (1, 256, 256, 8, 8, 128, True),
    (2, 100, 100, 4, 1, 32, True),      # ragged: tail rows and keys
    (1, 64, 192, 2, 2, 80, False),      # Sk > Sq, head_dim 80
    (1, 128, 128, 16, 2, 128, True),    # G = 8
    (1, 300, 300, 2, 1, 16, True),      # head_dim 16, tiles across G
    (1, 129, 255, 4, 2, 128, False),    # Sq, Sk not multiples of the 128-key tile
    (1, 40, 40, 8, 2, 128, True),       # a 128-row tile spans the G = 4 query heads
    (2, 129, 129, 4, 2, 80, True),      # head_dim 80: a partial second swizzle box
    (2, 255, 255, 4, 2, 64, True),      # head_dim 64, B > 1 with a ragged S
    (3, 255, 255, 4, 1, 128, True),     # a batch's last tile must not read the next
    # head_dim 256 (gemma-7b): 64-key tiles, P V on m64n256k16
    (1, 256, 256, 4, 4, 256, True),     # MHA, causal
    (1, 100, 300, 2, 2, 256, False),    # non-causal, Sk > Sq, ragged
    (2, 129, 129, 4, 2, 256, True),     # ragged S, B > 1
    (1, 40, 40, 8, 2, 256, True),       # a 128-row tile spans the G = 4 query heads
    (1, 65, 200, 4, 1, 192, False),     # head_dim 192: a fourth swizzle box all zeros
    # internvl2-26b's G = 6 and hubert-xlarge's non-causal head_dim 80
    (1, 300, 300, 12, 2, 128, True),    # G = 6: 64-row tiles span the query heads
    (2, 130, 130, 6, 1, 128, True),     # G = 6, one KV head, B > 1, ragged S
    (2, 300, 300, 4, 4, 80, False),     # MHA at head_dim 80, non-causal, ragged S
])
def test_flash_attention_matches_plain(dtype, B, Sq, Sk, Hq, nkv, hd, causal):
    _needs_card()
    q, k, v = _attn_inputs(Sq + hd, dtype, (B, Sq, Hq, hd), (B, Sk, nkv, hd),
                           (B, Sk, nkv, hd))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _assert_close(got, flash_attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,S_max,Hq,nkv,hd,kv_len", [
    (2, 1, 256, 4, 2, 64, 100),
    (1, 1, 1024, 8, 8, 128, 1024),
    (2, 4, 512, 4, 1, 32, 300),
    (1, 1, 96, 2, 2, 80, 7),
    (2, 1, 8192, 16, 8, 128, 6000),     # decode: keys split across blocks
    (1, 200, 512, 16, 8, 128, 300),     # prefill rows after 100 cached
    (1, 4, 128, 4, 2, 32, 140),         # kv_len > S_max: every slot visible
    (2, 40, 255, 8, 2, 128, 200),       # rows span the G = 4 heads, ragged S_max
    (2, 129, 300, 4, 2, 80, 255),       # head_dim 80, 129 rows after 126 cached
    (3, 1, 255, 16, 8, 64, 129),        # head_dim 64, B > 1, split at a ragged end
    (2, 1, 4096, 16, 8, 128, 4000),     # decode split, the cache's tail unwritten
    (2, 255, 255, 4, 2, 128, 255),      # prefill of a whole ragged cache, B > 1
    # head_dim 256 (gemma-7b)
    (1, 1, 4096, 16, 16, 256, 3001),    # decode: 64-key splits, the last one ragged
    (2, 1, 1000, 4, 2, 256, 777),       # G = 2, split at a ragged end
    (1, 100, 512, 4, 4, 256, 300),      # prefill rows after 200 cached
    (2, 40, 255, 8, 2, 256, 200),       # rows span the G = 4 heads, ragged S_max
    # internvl2-26b's G = 6
    (2, 1, 4096, 12, 2, 128, 2330),     # decode: 6 rows a KV head, keys split
    (1, 50, 512, 12, 2, 128, 306),      # prefill rows after 256 cached span the G = 6 heads
])
def test_decode_attention_matches_plain(dtype, B, Sq, S_max, Hq, nkv, hd, kv_len):
    _needs_card()
    q, k, v = _attn_inputs(S_max + kv_len, dtype, (B, Sq, Hq, hd), (B, S_max, nkv, hd),
                           (B, S_max, nkv, hd))
    before = decode_attention.launches
    got = decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    _assert_close(got, decode_attention_ref(q, k, v, kv_len), dtype)


@pytest.mark.cuda
def test_decode_attention_ignores_garbage_beyond_kv_len():
    _needs_card()
    q, k, v = _attn_inputs(1, torch.float32, (1, 1, 2, 32), (1, 4096, 2, 32),
                           (1, 4096, 2, 32))
    out1 = decode_attention(q, k, v, 50)
    k[:, 50:] = 1e4
    v[:, 50:] = float("nan")  # never read
    out2 = decode_attention(q, k, v, 50)
    torch.cuda.synchronize()
    assert torch.equal(out1, out2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,S_max,Hq,nkv,hd,kv_len", [
    (2, 1, 8192, 16, 8, 128, 3000),     # decode, keys split across blocks
    (2, 100, 1024, 16, 8, 128, 300),    # prefill rows after 200 cached
    (1, 4, 512, 4, 2, 80, 131),         # head_dim 80, kv_len inside a key tile
    (1, 1, 4096, 16, 16, 256, 3001),    # head_dim 256, decode split at a ragged end
    (2, 100, 1024, 4, 2, 256, 300),     # head_dim 256, prefill rows after 200 cached
])
def test_decode_attention_ignores_nan_past_kv_len(dtype, B, Sq, S_max, Hq, nkv, hd, kv_len):
    """Cache slots past kv_len poisoned with NaN: the output stays finite and
    equal, bit for bit, to the run over a clean cache."""
    _needs_card()
    q, k, v = _attn_inputs(kv_len, dtype, (B, Sq, Hq, hd), (B, S_max, nkv, hd),
                           (B, S_max, nkv, hd))
    clean = decode_attention(q, k, v, kv_len)
    k[:, kv_len:] = float("nan")
    v[:, kv_len:] = float("nan")
    poisoned = decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert torch.isfinite(poisoned).all()
    assert torch.equal(poisoned, clean)


@pytest.mark.cuda
def test_attention_wrappers_reject_what_the_kernels_do_not_take():
    _needs_card()
    q, k = _attn_inputs(2, torch.float16, (1, 8, 4, 64), (1, 8, 2, 64))
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q, k, k)
    qb, kb = q.bfloat16(), k.bfloat16()
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(qb, kb.transpose(1, 2).contiguous().transpose(1, 2), kb, 8)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(qb[..., :40], kb[..., :40], kb[..., :40])
    q, k = _attn_inputs(3, torch.bfloat16, (1, 8, 2, 272), (1, 8, 2, 272))
    with pytest.raises(ValueError, match="up to 256"):
        decode_attention(q, k, k, 8)


WKV6_TOL = 2e-3  # tests/test_kernels.py::TestWKV6


def _wkv6_inputs(seed, B, T, H, hs, dtype=torch.float32, w_range=(0.05, 0.999)):
    rng = np.random.default_rng(seed)
    r, v = (rng.normal(size=(B, T, H, hs)) for _ in range(2))
    k = rng.normal(size=(B, T, H, hs)) * 0.5
    w = rng.uniform(*w_range, size=(B, T, H, hs))
    u = rng.normal(size=(H, hs)) * 0.3
    cuda = lambda a, dt=torch.float32: torch.from_numpy(a.astype(np.float32)).to(dt).cuda()
    return cuda(r, dtype), cuda(k, dtype), cuda(v, dtype), cuda(w), cuda(u)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hs,chunk,dtype,with_state", [
    (2, 64, 2, 32, 16, torch.float32, False),     # the TestWKV6 cases
    (1, 100, 4, 64, 32, torch.float32, False),    # ragged T
    (2, 32, 1, 16, 32, torch.float32, False),
    (1, 128, 2, 64, 64, torch.float32, False),
    (2, 256, 3, 64, 64, torch.bfloat16, True),    # the model's chunk, carried state
    (1, 1000, 40, 64, 64, torch.bfloat16, True),  # ragged, two value tiles of 32
    (3, 77, 2, 32, 64, torch.float32, True),      # T shorter than one chunk
    (1, 4096, 4, 64, 64, torch.bfloat16, True),   # 64 chunks through the states scratch
    (2, 2, 3, 64, 64, torch.bfloat16, True),      # T = 2: one partial chunk
    (2, 17, 3, 64, 16, torch.float32, True),      # T = 17: a one-row second sub-chunk
    (2, 200, 2, 16, 64, torch.float32, True),     # hs = 16: one value tile, padded channels
    (1, 130, 3, 32, 64, torch.bfloat16, True),    # hs = 32: one value tile
    (1, 90, 2, 20, 64, torch.bfloat16, True),     # hs = 20: rows of 40 bytes, plain loads
])
def test_wkv6_matches_plain(B, T, H, hs, chunk, dtype, with_state):
    _needs_card()
    r, k, v, w, u = _wkv6_inputs(T + hs, B, T, H, hs, dtype)
    state = None
    if with_state:
        g = torch.Generator(device="cuda").manual_seed(T)
        state = torch.randn((B, H, hs, hs), generator=g, device="cuda") * 0.5
    for out_dtype in {dtype, torch.float32}:
        before = wkv6.launches
        out, S = wkv6(r, k, v, w, u, chunk=chunk, state=state, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert wkv6.launches == before + 1
        want, want_S = wkv6_chunked_ref(r, k, v, w, u, chunk=chunk, state=state,
                                        out_dtype=out_dtype)
        assert out.dtype == out_dtype and S.dtype == torch.float32
        # bfloat16 output: the tolerance plus one ulp of the value
        rtol = WKV6_TOL + (2**-7 if out_dtype == torch.bfloat16 else 0)
        torch.testing.assert_close(out.float(), want.float(), rtol=rtol, atol=WKV6_TOL)
        torch.testing.assert_close(S, want_S, rtol=WKV6_TOL, atol=WKV6_TOL)


@pytest.mark.cuda
def test_wkv6_strong_decay_stays_finite():
    _needs_card()
    r, k, v, w, u = _wkv6_inputs(5, 1, 64, 1, 16, w_range=(1e-6, 1e-6))
    out, S = wkv6(r, k, v, w, u, chunk=16)
    want, want_S = wkv6_chunked_ref(r, k, v, w, u, chunk=16)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(S).all()
    torch.testing.assert_close(out, want, rtol=WKV6_TOL, atol=WKV6_TOL)
    torch.testing.assert_close(S, want_S, rtol=WKV6_TOL, atol=WKV6_TOL)


@pytest.mark.cuda
def test_wkv6_at_the_decay_clamp_stays_finite():
    """w = 1e-8 (the clamp): a chunk's cumulative log reaches about -1180."""
    _needs_card()
    r, k, v, w, u = _wkv6_inputs(7, 2, 300, 4, 64, torch.bfloat16, w_range=(1e-8, 1e-8))
    state = torch.randn((2, 4, 64, 64), generator=torch.Generator(device="cuda").manual_seed(3),
                        device="cuda")
    out, S = wkv6(r, k, v, w, u, state=state, out_dtype=torch.float32)
    want, want_S = wkv6_chunked_ref(r, k, v, w, u, state=state, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(S).all()
    torch.testing.assert_close(out, want, rtol=WKV6_TOL, atol=WKV6_TOL)
    torch.testing.assert_close(S, want_S, rtol=WKV6_TOL, atol=WKV6_TOL)


@pytest.mark.cuda
def test_wkv6_wrapper_rejects_what_the_kernel_does_not_take():
    _needs_card()
    r, k, v, w, u = _wkv6_inputs(6, 1, 16, 2, 16)
    with pytest.raises(TypeError, match="float32"):
        wkv6(r, k, v, w.bfloat16(), u)
    with pytest.raises(ValueError, match="contiguous"):
        wkv6(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u)
    with pytest.raises(ValueError, match="chunk"):
        wkv6(r, k, v, w, u, chunk=128)


@pytest.mark.cuda
def test_wkv6_entry_rejects_a_states_scratch_of_another_chunk_count():
    """The C entry checks the scratch's chunk count against its own
    64-step chunks, so a wrapper that sized it otherwise gets an error,
    not writes past its end."""
    _needs_card()
    from repro_torch.kernels import _build

    lib = _build.load()
    r, k, v, w, u = _wkv6_inputs(8, 1, 130, 2, 16)  # three chunks of 64
    out, s_out = torch.empty_like(r), torch.empty((1, 2, 16, 16), device="cuda")
    states = torch.empty((1, 2, 3, 16, 16), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for n_chunks, want in ((2, False), (4, False), (3, True)):
        code = lib.wkv6_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                               u.data_ptr(), None, out.data_ptr(), s_out.data_ptr(),
                               states.data_ptr(), n_chunks, 0, 0, 1, 130, 2, 16, stream)
        assert (code == 0) == want, (n_chunks, code)
    torch.cuda.synchronize()
    want, want_S = wkv6_chunked_ref(r, k, v, w, u)
    torch.testing.assert_close(out, want, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(s_out, want_S, rtol=2e-3, atol=2e-3)


# ------------------------------------------------------------- the train path

@pytest.mark.cuda
def test_kernel_wrappers_refuse_autograd():
    """Under autograd with an operand that requires grad each ctypes
    wrapper raises (its output would carry no grad_fn and cut the gradient
    silently); under ``torch.no_grad`` the same call launches."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1, 64, 4, 64), generator=g, device="cuda", dtype=torch.bfloat16)
    k = torch.randn((1, 64, 2, 64), generator=g, device="cuda", dtype=torch.bfloat16)
    v = torch.randn_like(k)
    r, kk, vv, w, u = _wkv6_inputs(1, 1, 70, 2, 16)
    calls = {
        "flash_attention": lambda t: flash_attention(t, k, v, causal=True),
        "decode_attention": lambda t: decode_attention(t, k, v, 64),
        "wkv6": lambda t: wkv6(r, kk, vv, w, t),
    }
    operand = {"flash_attention": q, "decode_attention": q, "wkv6": u}
    for name, call in calls.items():
        leaf = operand[name].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match=f"{name}: called under autograd.*no backward"):
            call(leaf)
        with torch.no_grad():
            out = call(leaf)
        assert not (out[0] if isinstance(out, tuple) else out).requires_grad
        call(operand[name])  # no operand requires grad: launches


@pytest.mark.cuda
def test_train_step_refuses_the_kernels_on_card():
    """A train step asked for the kernels raises when built; the model's
    kernel path under autograd raises at the first attention call."""
    _needs_card()
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import StepConfig, build_train_step

    cfg = smoke_config("qwen3-0.6b")
    with pytest.raises(NotImplementedError, match="no gradient"):
        build_train_step(cfg, AdamWConfig(), StepConfig(use_flash=True))
    model = tf.init_params(cfg, seed=0, device="cuda")
    tokens = torch.zeros((2, 16), dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="flash_attention: called under autograd"):
        tf.loss_fn(model, cfg, {"tokens": tokens}, use_flash=True)


@pytest.mark.cuda
def test_full_width_train_step_on_card_matches_cpu():
    """qwen3-0.6b at full width (d_model 1024, vocab 151936), cut to 2
    layers and computed in float32: three train steps on the card against
    the same steps with the model on the CPU, from the same weights and
    batches.  Losses to 1e-4; weights to 1e-4 plus the lr applied (a
    gradient element near zero may turn its AdamW update around)."""
    _needs_card()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.train import build_train_step

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2, param_dtype="float32",
                              compute_dtype="float32")
    optim_cfg = AdamWConfig(lr=1e-2)
    step = build_train_step(cfg, optim_cfg)
    cpu = tf.init_params(cfg, seed=0, device="cpu")
    card = tf.Transformer(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    states = {"cpu": init_state(optim_cfg, dict(cpu.named_parameters())),
              "cuda": init_state(optim_cfg, dict(card.named_parameters()))}
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=2)
    lr_sum = 0.0
    for i in range(3):
        tokens = TokenPipeline(data, device="cpu").batch_at(i)["tokens"]
        states["cpu"], m_cpu = step(cpu, states["cpu"], {"tokens": tokens})
        states["cuda"], m_card = step(card, states["cuda"], {"tokens": tokens.cuda()})
        assert float(m_card["loss"]) == pytest.approx(float(m_cpu["loss"]), rel=1e-4)
        assert float(m_card["grad_norm"]) == pytest.approx(float(m_cpu["grad_norm"]), rel=1e-3)
        lr_sum += float(m_cpu["lr"])
    assert int(states["cuda"]["step"]) == 3
    for (n, a), b in zip(card.named_parameters(), cpu.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-4, atol=3 * lr_sum,
                                   msg=n)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,heads", [
    ("internvl2-26b", dict(n_heads=12, n_kv_heads=2, head_dim=128)),  # G = 6
    ("hubert-xlarge", dict(n_heads=4, n_kv_heads=4, head_dim=80)),    # non-causal, hd 80
])
def test_vlm_and_encoder_kernel_paths_on_card_match_cpu(arch, heads):
    """The smoke configs at internvl2-26b's G = 6 and hubert-xlarge's head
    dim 80, in float32: the kernel path's forward on the card against the
    same model on the CPU (the kernels' plain versions), and for the VLM a
    prefill of patches + text and two decode steps.  Logits to 1e-4."""
    _needs_card()
    import dataclasses

    from repro_torch.configs import ShapeConfig, concrete_batch, smoke_config
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32", **heads)
    cpu = tf.init_params(cfg, seed=0, device="cpu")
    card = tf.Transformer(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    batch = concrete_batch(cfg, ShapeConfig("p", "prefill", 40, 2), seed=1)
    on_card = {k: v.cuda() for k, v in batch.items()}
    close = lambda got, want: torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    before = flash_attention.launches
    with torch.no_grad():
        close(tf.forward(card, cfg, on_card, use_flash=True)[0],
              tf.forward(cpu, cfg, batch, use_flash=True)[0])
    assert flash_attention.launches == before + cfg.n_layers
    if cfg.family != "vlm":
        return
    states = [tf.init_decode_state(cfg, 2, 64, cache_dtype=torch.float32, device=d)
              for d in ("cpu", "cuda")]
    steps = [batch] + [{"tokens": batch["tokens"][:, i:i + 1],
                        "patches": batch["patches"][:, :0]} for i in range(2)]
    for step in steps:
        want, _ = tf.decode_step(cpu, cfg, states[0], step, use_flash=True)
        got, _ = tf.decode_step(card, cfg, states[1], {k: v.cuda() for k, v in step.items()},
                                use_flash=True)
        close(got, want)


@pytest.mark.cuda
def test_sharded_prefill_on_nccl_world1_equals_unsharded(tmp_path):
    """qwen3-0.6b's smoke config laid out by ``param_specs(fsdp=True)`` on a
    (1, 1) ("data", "model") mesh over an NCCL world of one rank, its cache
    by ``decode_state_specs``: the prefill through ``decode_attention`` (one
    launch a layer, on the local shards) equals the unsharded prefill's
    logits bit for bit, and a decode step too."""
    _needs_card()
    import datetime

    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import context, layout, rules

    cfg = smoke_config("qwen3-0.6b")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)).cuda()
    model = tf.init_params(cfg, seed=0, device="cuda")
    with torch.no_grad():
        want, state = tf.prefill(model, cfg, {"tokens": tokens[:, :40]}, 64, use_flash=True)
        want2, _ = tf.decode_step(model, cfg, state, {"tokens": tokens[:, 40:41]}, use_flash=True)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        sharded = tf.init_params(cfg, seed=0, device="cuda")
        layout.shard_module(sharded, mesh, rules.param_specs(
            dict(sharded.named_parameters()), rules.mesh_axes(mesh), fsdp=True,
            mesh_shape=rules.mesh_shape_of(mesh)))
        put = lambda t: layout.distribute(t, mesh, (("data",), None))
        launches = decode_attention.launches
        with torch.no_grad(), context.use_mesh(mesh):
            got, state = tf.prefill(sharded, cfg, {"tokens": put(tokens[:, :40])}, 64,
                                    use_flash=True)
            got2, _ = tf.decode_step(sharded, cfg, state, {"tokens": put(tokens[:, 40:41])},
                                     use_flash=True)
            got, got2 = layout.full(got), layout.full(got2)
        torch.cuda.synchronize()
        assert decode_attention.launches - launches == 2 * cfg.n_layers
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want)
    assert torch.equal(got2, want2)


@pytest.mark.cuda
@pytest.mark.parametrize("combiner", [False, True])
def test_every_device_op_of_a_fused_job_lies_in_a_phase_span(combiner):
    """Under ``torch.profiler`` every device operation of a fused job,
    the ctypes-launched ``segment_reduce`` / ``row_key_sums`` /
    ``local_reduce`` included (``_build.launch_range``), is launched inside
    one of the job's phase spans, and the kernels sit under their
    ``repro_torch::<name>`` ranges."""
    _needs_card()
    from torch.autograd import DeviceType

    corpus = torch.from_numpy(wordcount_corpus(1 << 20, vocab_size=4096, seed=3)).cuda()
    cfg = JobConfig(7, 3, 2, combiner=combiner, reduce_backend="cuda")
    job = build_job(wordcount(4096), cfg, len(corpus), device="cuda")
    job(corpus)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        job(corpus)
        torch.cuda.synchronize()
    events = prof.events()
    device_us = sum(e.time_range.elapsed_us() for e in events
                    if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    phases = {"mapreduce.map", "mapreduce.combine", "mapreduce.shuffle", "mapreduce.reduce"}
    # A launch the profiler interrupted to fetch a trace buffer is listed
    # twice, under an "Activity Buffer Request" of the same id.
    launched, seen = [], set()
    for e in events:
        if (e.device_type == DeviceType.CPU and e.kernels and e.id not in seen
                and e.name != "Activity Buffer Request"):
            seen.add(e.id)
            p = e
            while p is not None and p.name not in phases:
                p = p.cpu_parent
            launched.append((p and p.name, e))
    assert all(phase is not None for phase, _ in launched), \
        [e.name for phase, e in launched if phase is None]
    assert sum(k.duration for _, e in launched for k in e.kernels) == \
        pytest.approx(device_us, rel=1e-6)
    names = {e.name: e for _, e in launched if e.name.startswith("repro_torch::")}
    assert set(names) == {"repro_torch::segment_reduce", "repro_torch::row_key_sums",
                          "repro_torch::shuffle_merge"} | (
        {"repro_torch::local_reduce"} if combiner else set())
    # segment_reduce_*, row_key_sums_*, local_reduce_*, shuffle_* kernels
    # under their ranges
    assert all(any(name.split("::")[1].split("_")[0] in k.name for k in e.kernels)
               for name, e in names.items())


@pytest.mark.cuda
@pytest.mark.parametrize("combiner", [False, True])
def test_shuffle_split_and_merge_spans_hold_the_shuffle_device_time(combiner):
    """On the card a fused lexsort job's shuffle opens
    ``mapreduce.shuffle.split`` and ``mapreduce.shuffle.merge`` once each,
    and every device operation launched in the shuffle lies in one of them
    (the plain version's sort / gather / scatter spans stay shut)."""
    _needs_card()
    from torch.autograd import DeviceType

    corpus = torch.from_numpy(wordcount_corpus(1 << 20, vocab_size=4096, seed=3)).cuda()
    cfg = JobConfig(16, 7, 8, combiner=combiner, reduce_backend="cuda")
    job = build_job(wordcount(4096), cfg, len(corpus), device="cuda")
    job(corpus)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        job(corpus)
        torch.cuda.synchronize()
    events = prof.events()
    spans = [e.name for e in events if e.name.startswith("mapreduce.shuffle")
             and e.device_type == DeviceType.CPU]
    assert sorted(spans) == ["mapreduce.shuffle", "mapreduce.shuffle.merge",
                             "mapreduce.shuffle.split"]
    steps = {"mapreduce.shuffle.split": 0.0, "mapreduce.shuffle.merge": 0.0}
    shuffle_us, seen = 0.0, set()
    for e in events:
        if (e.device_type != DeviceType.CPU or not e.kernels or e.id in seen
                or e.name == "Activity Buffer Request"):
            continue
        seen.add(e.id)
        above, p = [], e.cpu_parent
        while p is not None:
            above.append(p.name)
            p = p.cpu_parent
        if "mapreduce.shuffle" not in above:
            continue
        us = sum(k.duration for k in e.kernels)
        shuffle_us += us
        step = [n for n in above if n in steps]
        assert step, (e.name, above)
        steps[step[0]] += us
    assert shuffle_us > 0 and all(us > 0 for us in steps.values())
    assert sum(steps.values()) == pytest.approx(shuffle_us, rel=1e-9)
