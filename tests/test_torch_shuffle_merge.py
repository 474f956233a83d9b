"""The ``shuffle_merge`` kernels' contract on the CPU.

The kernels run only on a card (``tests/test_torch_card.py`` holds them
against their plain version bit for bit); here: the kernel's uint32 hash,
mirrored in numpy, equals ``hash_to_reducer``; the precondition the kernels
rest on holds, since every task row that reaches the lexsort shuffle is
non-decreasing in key over its valid pairs, whatever the app, the combiner
and the mode; and on CPU and meta tensors ``LexsortShuffle.partition`` and
its plain version ``lexsort_partition`` return what the lexsort body
returned before the kernels, which is also what the reference's shuffle
returns, while the kernels' wrapper refuses them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.mapreduce as ref
import repro_torch.mapreduce as port
from repro_torch.kernels.shuffle_merge import shuffle_merge
from repro_torch.mapreduce import backends, phases
from repro_torch.mapreduce.backends import lexsort_partition
from repro_torch.mapreduce.phases import PAD_KEY
from repro_torch.telemetry import PhaseRecorder


def _kernel_hash(keys: np.ndarray, R: int) -> np.ndarray:
    """``reducer_of`` in ``csrc/shuffle_merge.cu``, in numpy's uint32."""
    h = keys.astype(np.int32).view(np.uint32) * np.uint32(2654435761)
    h ^= h >> np.uint32(16)
    return (h % np.uint32(R)).astype(np.int32)


@pytest.mark.parametrize("R", [1, 5, 7, 40])
def test_kernel_hash_mirror_equals_hash_to_reducer(R):
    rng = np.random.default_rng(R)
    keys = rng.integers(-(2**31), 2**31, size=100_000, dtype=np.int64).astype(np.int32)
    keys[:4] = [-(2**31), -1, 0, PAD_KEY]
    want = phases.hash_to_reducer(torch.from_numpy(keys), R).numpy()
    np.testing.assert_array_equal(_kernel_hash(keys, R), want)


def _old_lexsort_partition(cfg, keys, values, pvalid):
    """``LexsortShuffle.partition`` before the kernels, verbatim but for
    its spans."""
    R, W = cfg.num_reducers, cfg.num_workers
    keys, values, pvalid = (a.reshape(-1) for a in (keys, values, pvalid))
    rid = phases.hash_to_reducer(keys, R)
    rid = torch.where(pvalid, rid, R)
    order = backends._stable_order(rid, keys)
    skeys, svals, srid = keys[order], values[order], rid[order]
    cap = phases.partition_capacity(keys.shape[0], R, cfg.capacity_factor)
    R_pad = cfg.reduce_waves * W
    (part_keys, part_vals), dropped = phases.bucket_scatter(
        srid, R, R_pad, cap, (skeys, svals), (PAD_KEY, 0)
    )
    return part_keys, part_vals, dropped


def _rows(seed, M, C):
    """Spill-sorted rows with negative, INT32_MIN and valid INT32_MAX keys."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-50, 50, size=(M, C)).astype(np.int32)
    keys[rng.random((M, C)) < 0.05] = -(2**31)
    keys[rng.random((M, C)) < 0.05] = PAD_KEY
    valid = rng.random((M, C)) < 0.7
    vals = rng.integers(-1000, 1000, size=(M, C)).astype(np.int32)
    k, v, p = (torch.from_numpy(a) for a in (keys, vals, valid))
    _, order = torch.sort(torch.where(p, k, PAD_KEY), dim=1, stable=True)
    return k.gather(1, order), v.gather(1, order), p.gather(1, order)


@pytest.mark.parametrize("M,R,W,factor", [(1, 3, 1, 4.0), (7, 5, 2, 4.0), (16, 7, 8, 4.0),
                                          (5, 4, 3, 0.5), (4, 40, 4, 1.0)])
def test_cpu_wrapper_and_partition_equal_the_old_lexsort(M, R, W, factor):
    """On CPU tensors ``partition`` (rows, and the same pairs as one flat
    stream) and the plain version return what ``partition`` did before the
    kernels, ``dropped`` as an int32 scalar; a factor below 1 cuts pairs.
    The kernels' wrapper refuses CPU tensors and launches nothing."""
    cfg = port.JobConfig(M, R, W, capacity_factor=factor)
    k, v, p = _rows(M * R, M, 301)
    want = _old_lexsort_partition(cfg, k, v, p)
    shuffle = backends.get_shuffle_backend("lexsort")
    cap = phases.partition_capacity(k.numel(), R, factor)
    n_rows = cfg.reduce_waves * W
    for got in (shuffle.partition(cfg, k, v, p),
                shuffle.partition(cfg, k.reshape(-1), v.reshape(-1), p.reshape(-1)),
                lexsort_partition(k, v, p, R, cap, n_rows),
                lexsort_partition(k.reshape(-1), v.reshape(-1), p.reshape(-1), R, cap,
                                  n_rows)):
        assert got[0].shape == (n_rows, cap) and got[2].shape == ()
        assert got[2].dtype == torch.int32
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    if factor < 1:
        assert int(want[2]) > 0
    before = shuffle_merge.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        shuffle_merge(k, v, p, R, cap, n_rows)
    assert shuffle_merge.launches == before


@pytest.mark.parametrize("M,R,W", [(7, 5, 2), (16, 7, 8)])
def test_partition_equals_the_references_lexsort(M, R, W):
    """The same pairs through the reference's ``LexsortShuffle.partition``
    (one flat stream, ``jnp.lexsort``): equal slot for slot."""
    k, v, p = _rows(M + R, M, 257)
    got = backends.get_shuffle_backend("lexsort").partition(
        port.JobConfig(M, R, W), k, v, p)
    want = ref.get_shuffle_backend("lexsort").partition(
        ref.JobConfig(M, R, W), *(jnp.asarray(a.reshape(-1).numpy()) for a in (k, v, p)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_meta_wrapper_gives_the_old_lexsort_shapes():
    """On meta tensors (the cost estimator's pass) ``partition`` runs the
    plain version: the old body's shapes and dtypes, no launch; the
    kernels' wrapper refuses them."""
    cfg = port.JobConfig(16, 7, 1)
    k = torch.empty((16, 1000), dtype=torch.int32, device="meta")
    p = torch.empty((16, 1000), dtype=torch.bool, device="meta")
    want = _old_lexsort_partition(cfg, k, k, p)
    before = shuffle_merge.launches
    got = backends.get_shuffle_backend("lexsort").partition(cfg, k, k, p)
    assert shuffle_merge.launches == before
    for g, w in zip(got, want):
        assert g.device.type == "meta" and g.shape == w.shape and g.dtype == w.dtype
    with pytest.raises(ValueError, match="one CUDA device"):
        shuffle_merge(k, k, p, 7, 16)


APPS = {
    "wordcount": (lambda: port.wordcount(53), lambda: port.wordcount_corpus(3000, 53, seed=4)),
    "eximparse": (port.eximparse, lambda: port.exim_mainlog(3000, seed=4)),
}


@pytest.mark.parametrize("mode", ["fused", "pipelined", "traced"])
@pytest.mark.parametrize("combiner", [False, True])
@pytest.mark.parametrize("app", sorted(APPS))
def test_every_row_reaching_the_shuffle_is_sorted(app, combiner, mode, monkeypatch):
    """The kernels' precondition: each task row handed to the lexsort
    shuffle is non-decreasing in key over its valid pairs, with the map's
    spill sort alone and after the combine, at W = 2 and 3, neither of
    which divides M = 7."""
    make_app, make_corpus = APPS[app]
    corpus = torch.as_tensor(make_corpus())
    seen = []
    real = backends.LexsortShuffle.partition

    def spy(self, cfg, keys, values, pvalid):
        seen.append((keys.clone(), pvalid.clone()))
        return real(self, cfg, keys, values, pvalid)

    monkeypatch.setattr(backends.LexsortShuffle, "partition", spy)
    for W in (2, 3):
        cfg = port.JobConfig(7, 5, W, combiner=combiner)
        plan = port.ExecutionPlan(make_app(), cfg, len(corpus), device="cpu")
        job = {"fused": plan.fused, "pipelined": lambda: plan.pipelined(depth=2),
               "traced": lambda: plan.traced(PhaseRecorder())}[mode]()
        job(corpus)
    assert len(seen) == 2
    for keys, pvalid in seen:
        assert keys.dim() == 2 and keys.shape[0] == 7
        assert int(pvalid.sum()) > 0
        for row_k, row_p in zip(keys, pvalid):
            live = row_k[row_p]
            assert torch.all(live[1:] >= live[:-1])

