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
    segment_reduce,
    segment_reduce_ref,
)
from repro_torch.mapreduce import (
    ExecutionPlan,
    JobConfig,
    build_job,
    wordcount,
    wordcount_corpus,
)
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


@pytest.mark.cuda
@pytest.mark.parametrize("combiner", [False, True])
def test_cuda_backend_equals_torch_backend(combiner):
    _needs_card()
    corpus = torch.from_numpy(wordcount_corpus(50_000, 500, seed=3)).cuda()
    outs = {}
    for backend in ("cuda", "torch"):
        cfg = JobConfig(7, 3, 2, combiner=combiner, reduce_backend=backend)
        outs[backend] = build_job(wordcount(500), cfg, len(corpus))(corpus)
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
        seg, loc = segment_reduce.launches, local_reduce.launches
        got = plan.pipelined(depth=depth)(corpus)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, fused)), depth
        assert segment_reduce.launches - seg == -(-R // min(W * depth, R))
        assert local_reduce.launches - loc == int(combiner)
    recorder = PhaseRecorder()
    for depth in (1, 2):
        got = plan.traced(recorder, depth=depth)(corpus)
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
