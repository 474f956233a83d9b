"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``; each test skips when no CUDA device is present.  This
file imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.local_reduce import local_reduce, local_reduce_ref
from repro_torch.kernels.segment_reduce import (
    PAD_KEY,
    segment_reduce,
    segment_reduce_ref,
)
from repro_torch.mapreduce import JobConfig, build_job, wordcount, wordcount_corpus

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
