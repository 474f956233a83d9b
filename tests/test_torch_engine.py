"""The port's MapReduce engine against the reference engine, on the CPU.

The same seeded corpus and configuration go through
``repro.mapreduce.build_job`` and ``repro_torch.mapreduce.build_job``
(``device="cpu"``); ``(out_keys, out_vals, dropped)`` must agree bit for
bit.  Each port reduce backend is held against the reference backend of
the same role (``convert.REFERENCE_BACKEND_NAMES``); ``cuda`` runs its
kernels' plain versions here and meets the Pallas backend at a few
thousand tokens, below its 2**24 exactness bound.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.mapreduce as ref
import repro_torch.mapreduce as port
from repro.mapreduce import phases as ref_phases
from repro_torch.convert import REFERENCE_BACKEND_NAMES, job_config_from_reference
from repro_torch.mapreduce import phases as port_phases

PAD = int(ref.PAD_KEY)
TOKENS = 3001  # not a multiple of M or of the Exim record width

CORPORA = {
    "wordcount": ref.wordcount_corpus(TOKENS, vocab_size=257, seed=1),
    "eximparse": ref.exim_mainlog(TOKENS, 200, seed=2),
}
APPS = {
    "wordcount": (ref.wordcount(257), port.wordcount(257)),
    "eximparse": (ref.eximparse(200), port.eximparse(200)),
}


def _run_both(ref_app, port_app, corpus, **cfg):
    ref_cfg = ref.JobConfig(**cfg)
    port_cfg = job_config_from_reference(dataclasses.asdict(ref_cfg))
    want = ref.build_job(ref_app, ref_cfg, len(corpus))(corpus)
    got = port.build_job(port_app, port_cfg, len(corpus), device="cpu")(corpus)
    return got, want


def _assert_bit_exact(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("app,M,R,W,backend", [
    ("wordcount", 4, 3, 1, "jnp"),
    ("wordcount", 5, 3, 2, "jnp"),     # W does not divide M
    ("wordcount", 3, 2, 4, "jnp"),     # W > M and W > R
    ("eximparse", 7, 5, 3, "jnp"),
    ("eximparse", 3, 2, 4, "jnp"),
    ("wordcount", 5, 3, 2, "xla"),
    ("eximparse", 4, 3, 1, "xla"),
    ("wordcount", 5, 3, 2, "pallas"),
    ("eximparse", 3, 2, 4, "pallas"),
])
def test_matches_reference(app, M, R, W, backend):
    got, want = _run_both(*APPS[app], CORPORA[app], num_mappers=M,
                          num_reducers=R, num_workers=W, reduce_backend=backend)
    _assert_bit_exact(got, want)
    assert int(got[2]) == 0


def _group_map(np_mod):
    """keys = token % 13, values = token: an app for the max/first ops."""
    if np_mod is jnp:
        def map_fn(tokens, valid):
            keys = jnp.where(valid, tokens % 13, PAD)
            return keys, tokens.astype(jnp.int32), valid
    else:
        def map_fn(tokens, valid):
            keys = torch.where(valid, tokens % 13, PAD)
            return keys, tokens.to(torch.int32), valid
    return map_fn


@pytest.mark.parametrize("op", ["sum", "max", "first"])
@pytest.mark.parametrize("backend", ["jnp", "xla"])
def test_reduce_ops(op, backend):
    corpus = np.random.default_rng(5).integers(0, 1000, 900).astype(np.int32)
    ref_app = ref.MapReduceApp("group", 13, _group_map(jnp), reduce_op=op)
    port_app = port.MapReduceApp("group", 13, _group_map(torch), reduce_op=op)
    got, want = _run_both(ref_app, port_app, corpus, num_mappers=5,
                          num_reducers=3, num_workers=2,
                          capacity_factor=8.0, reduce_backend=backend)
    _assert_bit_exact(got, want)


def test_skew_drops_are_counted_like_the_reference():
    corpus = np.zeros(1000, dtype=np.int32)  # one key: maximal skew
    got, want = _run_both(*APPS["wordcount"], corpus, num_mappers=2,
                          num_reducers=8, capacity_factor=1.0)
    _assert_bit_exact(got, want)
    dropped = int(got[2])
    assert dropped > 0
    assert port.collect_results(got[0], got[1])[0] + dropped == 1000


@pytest.mark.parametrize("app,backend", [("wordcount", "jnp"),
                                         ("eximparse", "pallas")])
def test_combiner(app, backend):
    """Combiner on: bit-exact against the reference's combiner run, and the
    same results as the port's run without it."""
    kw = dict(num_mappers=5, num_reducers=3, num_workers=2,
              reduce_backend=backend)
    got, want = _run_both(*APPS[app], CORPORA[app], combiner=True, **kw)
    _assert_bit_exact(got, want)
    port_cfg = job_config_from_reference(dataclasses.asdict(ref.JobConfig(**kw)))
    plain = port.build_job(APPS[app][1], port_cfg, TOKENS, device="cpu")(
        CORPORA[app])
    assert port.collect_results(got[0], got[1]) == port.collect_results(
        plain[0], plain[1])


def test_first_with_combiner_rejected():
    app = port.MapReduceApp("firstapp", 8, _group_map(torch), reduce_op="first")
    with pytest.raises(ValueError, match="combiner"):
        port.ExecutionPlan(app, port.JobConfig(2, 2, combiner=True), 64,
                           device="cpu")
    port.ExecutionPlan(app, port.JobConfig(2, 2), 64, device="cpu")


def test_cuda_backend_rejects_other_ops():
    app = port.MapReduceApp("maxapp", 8, _group_map(torch), reduce_op="max")
    with pytest.raises(ValueError, match="supports"):
        port.build_job(app, port.JobConfig(2, 2, reduce_backend="cuda"), 64,
                       device="cpu")


def test_all_to_all_needs_a_group():
    """The collective shuffle runs on a process group, as the reference's
    needs a mesh: without ``group=`` build_job refuses, naming it."""
    cfg = port.JobConfig(2, 2, shuffle_backend="all_to_all")
    with pytest.raises(ValueError, match="group="):
        port.build_job(APPS["wordcount"][1], cfg, 64, device="cpu")


def test_group_refused_with_lexsort():
    with pytest.raises(ValueError, match="single-controller"):
        port.build_job(APPS["wordcount"][1], port.JobConfig(2, 2), 64,
                       group=object(), device="cpu")


def test_sharded_without_a_process_group_raises():
    """No initialised process group: the sharded mode raises and never runs
    the emulated mode in its place."""
    cfg = port.JobConfig(2, 2, shuffle_backend="all_to_all")
    with pytest.raises(RuntimeError, match="process group"):
        port.build_job_sharded(APPS["wordcount"][1], cfg, 64, None, device="cpu")


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.build_job(APPS["wordcount"][1], port.JobConfig(2, 2), 64)


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="unknown reduce backend"):
        port.JobConfig(2, 2, reduce_backend="jnp")


@pytest.mark.parametrize("seed", [0, 7])
def test_corpora_identical(seed):
    np.testing.assert_array_equal(
        port.wordcount_corpus(5000, vocab_size=300, seed=seed),
        ref.wordcount_corpus(5000, vocab_size=300, seed=seed))
    np.testing.assert_array_equal(
        port.exim_mainlog(5000, 100, seed=seed),
        ref.exim_mainlog(5000, 100, seed=seed))


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("n_tokens,n_txn", [(1, 3), (2, 2), (6001, 8),
                                            (100_003, 1024), (77, 1)])
def test_exim_corpus_identical_at_every_size(seed, n_tokens, n_txn):
    """The vectorised burst draws equal the reference's scalar loop."""
    np.testing.assert_array_equal(
        port.exim_mainlog(n_tokens, n_txn, seed=seed),
        ref.exim_mainlog(n_tokens, n_txn, seed=seed))


def test_exim_bursts_vectorised_equal_loop_and_state():
    """Draws and generator state after them equal the loop's, and a
    generator holding a buffered half word takes the loop."""
    from repro_torch.mapreduce.datagen import _bursts, _bursts_loop

    for pre_draw in (False, True):
        a, b = np.random.default_rng(5), np.random.default_rng(5)
        if pre_draw:
            a.integers(0, 9), b.integers(0, 9)
        np.testing.assert_array_equal(_bursts(a, 9001, 300),
                                      _bursts_loop(b, 9001, 300))
        sa, sb = a.bit_generator.state, b.bit_generator.state
        # ``uinteger`` is a stale half word unless ``has_uint32`` is set
        assert (sa["state"], sa["has_uint32"]) == (sb["state"], sb["has_uint32"])
        assert [int(a.integers(0, 7)) for _ in range(9)] == \
            [int(b.integers(0, 7)) for _ in range(9)]
        np.testing.assert_array_equal(a.integers(0, 8, 50),
                                      b.integers(0, 8, 50))


def test_hash_to_reducer_wraps_like_uint32():
    rng = np.random.default_rng(3)
    keys = np.concatenate([
        rng.integers(-2**31, 2**31, 5000, dtype=np.int64),
        [0, -1, 1, -2**31, 2**31 - 1],
    ]).astype(np.int32)
    for R in (1, 3, 40):
        np.testing.assert_array_equal(
            port_phases.hash_to_reducer(torch.from_numpy(keys), R).numpy(),
            np.asarray(ref_phases.hash_to_reducer(jnp.asarray(keys), R)))


@pytest.mark.parametrize("cap", [1, 4, 50])
def test_bucket_scatter_matches_reference(cap):
    rng = np.random.default_rng(cap)
    ids = np.sort(rng.integers(0, 7, 300)).astype(np.int32)  # 6 = invalid
    vals = rng.integers(-50, 50, 300).astype(np.int32)
    (wk, wv), wd = ref_phases.bucket_scatter(
        jnp.asarray(ids), 6, 8, cap, (jnp.asarray(ids), jnp.asarray(vals)),
        (PAD, 0))
    (gk, gv), gd = port_phases.bucket_scatter(
        torch.from_numpy(ids), 6, 8, cap,
        (torch.from_numpy(ids), torch.from_numpy(vals)), (PAD, 0))
    _assert_bit_exact((gk, gv, gd), (wk, wv, wd))


def test_backend_name_table_covers_reference_registry():
    assert set(REFERENCE_BACKEND_NAMES) == set(ref.REDUCE_BACKENDS)
    assert set(REFERENCE_BACKEND_NAMES.values()) == set(port.REDUCE_BACKENDS)
