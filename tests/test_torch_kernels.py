"""The port's kernel modules against the reference's Pallas kernels.

Same seeded inputs (numpy) through the reference's Pallas kernels (interpret
mode on the CPU) and oracles, and through the port's wrappers, which take
their plain PyTorch versions for CPU tensors.  Integer paths: bit for bit.
Inputs keep values below 2**24, where the Pallas float32 sum is exact.
The CUDA kernels themselves are held against the plain versions on a
card in ``tests/test_torch_card.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.local_reduce import local_reduce as jax_local_reduce
from repro.kernels.local_reduce import local_reduce_ref as jax_local_reduce_ref
from repro.kernels.segment_reduce import PAD_KEY
from repro.kernels.segment_reduce import segment_reduce as jax_segment_reduce
from repro.kernels.segment_reduce import segment_reduce_ref as jax_segment_reduce_ref
from repro_torch.kernels import _build
from repro_torch.kernels.local_reduce import local_reduce, local_reduce_ref
from repro_torch.kernels.segment_reduce import segment_reduce, segment_reduce_ref

PAD = int(PAD_KEY)

KERNELS = {
    "segment_reduce": (segment_reduce, segment_reduce_ref,
                       jax_segment_reduce, jax_segment_reduce_ref),
    "local_reduce": (local_reduce, local_reduce_ref,
                     jax_local_reduce, jax_local_reduce_ref),
}


def _sorted_rows(rng, n_rows, n_cols, nkeys):
    """Key-sorted int32 rows with a random PAD_KEY tail (the cases of
    tests/test_kernels.py::TestSegmentReduce / TestLocalReduce)."""
    keys = rng.integers(0, nkeys, size=(n_rows, n_cols)).astype(np.int32)
    for r in range(n_rows):
        npad = int(rng.integers(0, n_cols // 3))
        if npad:
            keys[r, -npad:] = PAD
        keys[r] = np.sort(keys[r])
    vals = rng.integers(1, 10, size=(n_rows, n_cols)).astype(np.int32)
    return keys, vals


def _assert_all_equal(port_out, jax_out):
    for p, j in zip(port_out, jax_out):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("R,C,nkeys", [(3, 64, 10), (1, 128, 5),
                                       (4, 32, 32), (2, 256, 100)])
def test_matches_pallas_and_oracle(name, R, C, nkeys):
    kern, ref, jax_kern, jax_ref = KERNELS[name]
    keys, vals = _sorted_rows(np.random.default_rng(R * 1000 + C), R, C, nkeys)
    port = kern(torch.from_numpy(keys), torch.from_numpy(vals))
    _assert_all_equal(port, ref(torch.from_numpy(keys), torch.from_numpy(vals)))
    _assert_all_equal(port, jax_kern(jnp.asarray(keys), jnp.asarray(vals)))
    for r in range(R):
        _assert_all_equal(
            (port[0][r], port[1][r]),
            jax_ref(jnp.asarray(keys[r]), jnp.asarray(vals[r])),
        )


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_all_pad_rows(name):
    """Empty rows (a task past the corpus tail) stay all (PAD_KEY, 0)."""
    kern = KERNELS[name][0]
    ok, ov = kern(torch.full((2, 64), PAD, dtype=torch.int32),
                  torch.ones((2, 64), dtype=torch.int32))
    assert (ok == PAD).all() and (ov == 0).all()


@pytest.mark.parametrize("name", sorted(KERNELS))
@given(c=st.sampled_from([16, 64, 128]), nkeys=st.integers(1, 40),
       seed=st.integers(0, 10_000))
@settings(max_examples=15, deadline=None)
def test_property_one_row(name, c, nkeys, seed):
    """1-D rows: the Pallas output bit for bit, sum conserved, one live slot
    per distinct key."""
    kern, _, jax_kern, _ = KERNELS[name]
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, nkeys, c).astype(np.int32))
    vals = rng.integers(0, 100, c).astype(np.int32)
    ok, ov = kern(torch.from_numpy(keys), torch.from_numpy(vals))
    _assert_all_equal((ok, ov), jax_kern(jnp.asarray(keys), jnp.asarray(vals)))
    assert int(ov.sum()) == int(vals.sum())
    assert int((ok != PAD).sum()) == len(set(keys.tolist()))


def test_local_reduce_front_packs_ascending():
    keys = torch.tensor([[2, 2, 5, 9, 9, 9, PAD, PAD]], dtype=torch.int32)
    vals = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8]], dtype=torch.int32)
    ok, ov = local_reduce(keys, vals)
    assert ok.tolist() == [[2, 5, 9, PAD, PAD, PAD, PAD, PAD]]
    assert ov.tolist() == [[3, 3, 15, 0, 0, 0, 0, 0]]


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_cpu_tensors_take_the_plain_version(name):
    kern = KERNELS[name][0]
    before = kern.launches
    keys, vals = _sorted_rows(np.random.default_rng(0), 2, 32, 5)
    kern(torch.from_numpy(keys), torch.from_numpy(vals))
    assert kern.launches == before


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_non_cpu_tensors_never_fall_back(name):
    """Anything but two CPU tensors goes to the kernel's checks, which
    raise rather than run the plain version."""
    kern = KERNELS[name][0]
    keys = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kern(keys, torch.zeros((2, 8), dtype=torch.int32, device="meta"))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
