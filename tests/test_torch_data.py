"""The port's token pipeline, on the CPU.

The port draws its batches from numpy's generator keyed by (seed, step,
host id), not from JAX's threefry stream, so its numbers are its own:
these tests hold the contract of ``tests/test_substrate.py``'s
``TestDataPipeline`` and the reference's structure rule, exactly, on the
port's batches and on the reference's own draws.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JaxDataConfig
from repro.data import TokenPipeline as JaxTokenPipeline
from repro_torch.data import DataConfig, TokenPipeline, host_batches
from repro_torch.data.pipeline import structured_tokens


def _tokens(p, step):
    return p.batch_at(step)["tokens"].numpy()


def test_deterministic_and_resumable():
    cfg = DataConfig(vocab_size=128, seq_len=16, global_batch=8, seed=3)
    p = TokenPipeline(cfg, device="cpu")
    a, b = _tokens(p, 5), _tokens(p, 5)  # constant-time re-fetch
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, _tokens(p, 6))
    # a new pipeline resumed from the state dict continues the same stream
    again = TokenPipeline(cfg, device="cpu")
    np.testing.assert_array_equal(_tokens(again, TokenPipeline.resume_step(p.state_dict(5))), a)
    assert p.state_dict(5) == {"step": 5, "seed": 3}
    assert not np.array_equal(a, _tokens(TokenPipeline(DataConfig(128, 16, 8, seed=4),
                                                       device="cpu"), 5))


def test_batch_shape_dtype_device():
    cfg = DataConfig(vocab_size=100, seq_len=12, global_batch=6)
    batch = TokenPipeline(cfg, device="cpu").batch_at(0)
    assert set(batch) == {"tokens"}
    t = batch["tokens"]
    assert t.shape == (6, 12) and t.dtype == torch.int32 and t.device.type == "cpu"
    assert int(t.min()) >= 0 and int(t.max()) < 100
    jt = JaxTokenPipeline(JaxDataConfig(vocab_size=100, seq_len=12, global_batch=6)).batch_at(0)
    assert np.asarray(jt["tokens"]).dtype == t.numpy().dtype and jt["tokens"].shape == t.shape


def test_host_sharding_partitions_batch():
    cfg = DataConfig(vocab_size=128, seq_len=8, global_batch=8, seed=0)
    hosts = [TokenPipeline(cfg, host_id=i, n_hosts=4, device="cpu") for i in range(4)]
    slices = [_tokens(h, 0) for h in hosts]
    assert all(s.shape == (2, 8) for s in slices)
    for a, b in itertools.combinations(slices, 2):
        assert not np.array_equal(a, b)


def test_indivisible_hosts_rejected():
    cfg = DataConfig(vocab_size=16, seq_len=4, global_batch=10)
    with pytest.raises(ValueError):
        TokenPipeline(cfg, host_id=0, n_hosts=4, device="cpu")


def test_no_card_refused_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenPipeline(DataConfig(vocab_size=16, seq_len=4, global_batch=2))


@pytest.mark.parametrize("seed,step,host", [(0, 0, 0), (3, 7, 1), (11, 1000, 2)])
def test_structure_rule_exact(seed, step, host):
    """The port's batch is the reference's rule applied to the port's
    draws, element for element: (seed, step, host id) keys the generator;
    uniform tokens, and odd positions with the gate set are
    ``(previous token * 7 + 1) % V``."""
    V, S = 97, 33
    cfg = DataConfig(vocab_size=V, seq_len=S, global_batch=6, seed=seed, structure=0.7)
    got = _tokens(TokenPipeline(cfg, host_id=host, n_hosts=3, device="cpu"), step)
    rng = np.random.default_rng([seed, step, host])
    base = rng.integers(0, V, (2, S), dtype=np.int32)
    gate = rng.random((2, S)) < 0.7
    for b, t in itertools.product(range(2), range(S)):
        if t % 2 == 1 and gate[b, t]:
            assert got[b, t] == (int(base[b, t - 1]) * 7 + 1) % V
        else:
            assert got[b, t] == base[b, t]


def test_structure_rule_matches_reference_formula():
    """``structured_tokens`` on the reference's own draws equals the
    reference's ``batch_at`` (same key split as ``TokenPipeline.batch_at``)."""
    cfg = JaxDataConfig(vocab_size=211, seq_len=40, global_batch=4, seed=5, structure=0.6)
    want = np.asarray(JaxTokenPipeline(cfg).batch_at(9)["tokens"])
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(5), 9), 0)
    k1, k2 = jax.random.split(key)
    base = np.asarray(jax.random.randint(k1, (4, 40), 0, 211, dtype=jnp.int32))
    gate = np.asarray(jax.random.bernoulli(k2, 0.6, (4, 40)))
    np.testing.assert_array_equal(structured_tokens(base, gate, 211), want)


def test_structure_share_and_learnable_floor():
    """Across a large batch the share of structured odd positions is about
    ``structure`` (plus the 1 / V chance hits), as in the reference's."""
    V = 512
    for pipe in (TokenPipeline(DataConfig(V, 256, 64, seed=1, structure=0.9), device="cpu"),
                 JaxTokenPipeline(JaxDataConfig(V, 256, 64, seed=1, structure=0.9))):
        t = np.asarray(pipe.batch_at(0)["tokens"]).astype(np.int64)
        hit = t[:, 1::2] == (t[:, 0::2] * 7 + 1) % V
        assert abs(hit.mean() - (0.9 + 0.1 / V)) < 0.01


def test_host_batches_iterates_from_start():
    p = TokenPipeline(DataConfig(vocab_size=50, seq_len=6, global_batch=2), device="cpu")
    it = host_batches(p, start_step=4)
    for want_step in (4, 5, 6):
        step, batch = next(it)
        assert step == want_step
        np.testing.assert_array_equal(batch["tokens"].numpy(), _tokens(p, want_step))
