"""The port's RWKV6 path against the reference, on the CPU.

Inputs come from seeded numpy generators and go to both packages.  The
WKV6 recurrence: the port's plain versions (the step scan and the chunked
form the kernel is held against on the card) against the reference's
Pallas kernel in interpret mode and its step-scan oracle, at the cases of
``tests/test_kernels.py::TestWKV6`` and its tolerance, 2e-3; the port's
chunk against ``repro.models.ssm._rwkv_chunk`` from a non-zero state, to
1e-5 of the output's scale (float32 on both sides, summation order apart).  The time-mix and
channel-mix, and the rwkv6-3b smoke model with the reference's weights
carried by ``convert.lm_params_from_reference``, compute in bfloat16 in
both packages: 2e-2, the tolerance of ``tests/test_models_smoke.py``.
The reference's blocks run compiled (under ``lax.scan``), where XLA
rounds some ops otherwise than op by op; the mixes are held against the
compiled functions for that reason.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.rwkv6 import wkv6 as jax_wkv6
from repro.kernels.rwkv6 import wkv6_ref as jax_wkv6_ref
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels.rwkv6 import (
    wkv6,
    wkv6_chunk,
    wkv6_chunked_ref,
    wkv6_ref,
    wkv6_two_pass_ref,
)
from repro_torch.models import ssm
from repro_torch.models import transformer as tf

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "rwkv6-3b"
WKV_TOL = 2e-3
TOL = 2e-2


def _wkv_inputs(seed, B, T, H, hs, w_range=(0.05, 0.999)):
    """(jax arrays, torch tensors) of r, k, v, w (B, T, H, hs) and u (H, hs),
    drawn as TestWKV6 draws them."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(B, T, H, hs))
    k = rng.normal(size=(B, T, H, hs)) * 0.5
    v = rng.normal(size=(B, T, H, hs))
    w = rng.uniform(*w_range, size=(B, T, H, hs))
    u = rng.normal(size=(H, hs)) * 0.3
    arrays = [a.astype(np.float32) for a in (r, k, v, w, u)]
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol=TOL):
    if isinstance(want, torch.Tensor):
        want = want.detach().float().numpy()
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


WKV_CASES = [
    (2, 64, 2, 32, 16),
    (1, 100, 4, 64, 32),   # ragged T: the padding path
    (2, 32, 1, 16, 32),
    (1, 128, 2, 64, 64),
]


@pytest.mark.parametrize("B,T,H,hs,chunk", WKV_CASES)
def test_wkv6_plain_versions_match_pallas_and_oracle(B, T, H, hs, chunk):
    jx, th = _wkv_inputs(B * T + hs, B, T, H, hs)
    want, want_S = jax_wkv6(*jx, chunk=chunk)
    oracle, oracle_S = jax_wkv6_ref(*jx)
    for got, got_S in (wkv6_chunked_ref(*th, chunk=chunk), wkv6_ref(*th)):
        assert got.shape == (B, T, H, hs) and got_S.shape == (B, H, hs, hs)
        for w, w_S in ((want, want_S), (oracle, oracle_S)):
            _close(got, w, WKV_TOL)
            _close(got_S, w_S, WKV_TOL)


def test_wkv6_strong_decay_stays_finite():
    jx, th = _wkv_inputs(3, 1, 64, 1, 16, w_range=(1e-6, 1e-6))
    out, S = wkv6(*th, chunk=16)  # CPU tensors: the plain version
    assert torch.isfinite(out).all() and torch.isfinite(S).all()
    want, want_S = jax_wkv6(*jx, chunk=16)
    _close(out, want, WKV_TOL)
    _close(S, want_S, WKV_TOL)


@pytest.mark.parametrize("chunk", [16, 64])
def test_chunk_matches_reference_chunk_from_a_state(chunk):
    jx, th = _wkv_inputs(4, 2, chunk, 3, 16)
    S0 = np.random.default_rng(5).normal(size=(2, 3, 16, 16)).astype(np.float32)
    r, k, v, w, u = jx
    want, want_S = jssm._rwkv_chunk(jnp.asarray(S0), r, k, v, w, u)
    got, got_S = wkv6_chunk(torch.from_numpy(S0), *th)
    # float32 on both sides, summed in another order: 1e-5 of each output's
    # scale (its largest magnitude, about 10 here)
    for g, w in ((got, want), (got_S, want_S)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


def test_wrapper_carries_state_and_output_dtype():
    """The wrapper's state and out_dtype on CPU tensors: two calls from a
    carried state equal one call, and equal the step scan from that state."""
    _, (r, k, v, w, u) = _wkv_inputs(6, 2, 150, 2, 32)
    S0 = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 2, 32, 32)).astype(np.float32))
    whole, S_whole = wkv6(r, k, v, w, u, state=S0)
    a, S_a = wkv6(r[:, :70], k[:, :70], v[:, :70], w[:, :70], u, state=S0)
    b, S_b = wkv6(r[:, 70:], k[:, 70:], v[:, 70:], w[:, 70:], u, state=S_a,
                  out_dtype=torch.bfloat16)
    assert b.dtype == torch.bfloat16 and S_b.dtype == torch.float32
    _close(a, whole[:, :70], WKV_TOL)
    np.testing.assert_allclose(b.float().numpy(), whole[:, 70:].numpy(),
                               rtol=WKV_TOL + 2**-8, atol=WKV_TOL)  # rounded once
    _close(S_b, S_whole, WKV_TOL)
    scan, S_scan = wkv6_ref(r, k, v, w, u, S0)
    _close(whole, scan, WKV_TOL)
    _close(S_whole, S_scan, WKV_TOL)


def _close_to_scale(got, want, tol=2e-5):
    """float32 on both sides, summed in another order: ``tol`` relative, and
    ``tol`` of the output's scale (its largest magnitude, 5-20 here) absolute."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("B,T,H,hs,chunk", WKV_CASES + [(2, 9, 2, 16, 16)])  # and T < 16
def test_two_pass_matches_pallas(B, T, H, hs, chunk):
    """The kernels' algorithm (chunk states, then outputs by sub-chunk
    factorisation, in chunks of 64 whatever ``chunk`` is) against the Pallas
    kernel in interpret mode from a zero state."""
    jx, th = _wkv_inputs(B * T + hs + 1, B, T, H, hs)
    want, want_S = jax_wkv6(*jx, chunk=chunk)
    got, got_S = wkv6_two_pass_ref(*th)
    assert got.shape == (B, T, H, hs) and got_S.shape == (B, H, hs, hs)
    _close_to_scale(got, want)
    _close_to_scale(got_S, want_S)


def _reference_chunks(S0, jx, chunk=64):
    """``repro.models.ssm._rwkv_chunk`` over the sequence from S0, a ragged
    T padded with w = 1 and r = k = v = 0 as the reference pads it."""
    r, k, v, w, u = (np.asarray(a) for a in jx)
    T = r.shape[1]
    pad = (-T) % chunk
    widths = ((0, 0), (0, pad), (0, 0), (0, 0))
    r, k, v = (np.pad(a, widths) for a in (r, k, v))
    w = np.pad(w, widths, constant_values=1.0)
    S, outs = jnp.asarray(S0), []
    for c0 in range(0, T + pad, chunk):
        sl = slice(c0, c0 + chunk)
        out, S = jssm._rwkv_chunk(S, *(jnp.asarray(a[:, sl]) for a in (r, k, v, w)),
                                  jnp.asarray(u))
        outs.append(np.asarray(out))
    return np.concatenate(outs, axis=1)[:, :T], np.asarray(S)


@pytest.mark.parametrize("T,w_range,ref_tol", [
    (150, (0.05, 0.999), 2e-5),  # a carried state across three chunks, the last ragged
    (17, (0.05, 0.999), 2e-5),   # one ragged chunk, a second sub-chunk of one row
    (7, (0.05, 0.999), 2e-5),    # T < 16
    (130, (1e-6, 1e-6), WKV_TOL),  # strong decay
    (100, (1e-8, 1e-8), WKV_TOL),  # w at the 1e-8 clamp
    (70, (1e-12, 1e-9), WKV_TOL),  # w below the clamp
])
def test_two_pass_matches_reference_chunks_from_a_state(T, w_range, ref_tol):
    """From a non-zero state, against the reference's chunk scan and the
    port's chunked form.  Under strong decay a chunk's cumulative log
    reaches -880 to -1180, whose float32 ulp (6e-5 to 1.2e-4) the two
    frameworks' cumsums round differently (by up to 1.2e-4); each decay
    factor moves with it, so the reference is held there at TestWKV6's
    2e-3, and the port's chunked form, which shares the cumsum, at 2e-5."""
    jx, th = _wkv_inputs(T + 11, 2, T, 3, 32, w_range=w_range)
    S0 = np.random.default_rng(T).normal(size=(2, 3, 32, 32)).astype(np.float32) * 0.5
    want, want_S = _reference_chunks(S0, jx)
    got, got_S = wkv6_two_pass_ref(*th, state=torch.from_numpy(S0))
    assert torch.isfinite(got).all() and torch.isfinite(got_S).all()
    _close_to_scale(got, want, ref_tol)
    _close_to_scale(got_S, want_S, ref_tol)
    same, same_S = wkv6_chunked_ref(*th, state=torch.from_numpy(S0))
    _close_to_scale(got, same.numpy())
    _close_to_scale(got_S, same_S.numpy())


def test_two_pass_carries_state_and_output_dtype():
    """Two calls from a carried state equal one call; out_dtype as asked."""
    _, (r, k, v, w, u) = _wkv_inputs(8, 1, 200, 2, 16)
    S0 = torch.from_numpy(np.random.default_rng(9).normal(size=(1, 2, 16, 16)).astype(np.float32))
    whole, S_whole = wkv6_two_pass_ref(r, k, v, w, u, state=S0)
    a, S_a = wkv6_two_pass_ref(r[:, :90], k[:, :90], v[:, :90], w[:, :90], u, state=S0)
    b, S_b = wkv6_two_pass_ref(r[:, 90:], k[:, 90:], v[:, 90:], w[:, 90:], u, state=S_a,
                               out_dtype=torch.bfloat16)
    assert b.dtype == torch.bfloat16 and S_b.dtype == torch.float32
    _close_to_scale(a, whole[:, :90])
    np.testing.assert_allclose(b.float().numpy(), whole[:, 90:].numpy(),
                               rtol=2**-8, atol=2e-5)  # rounded once
    _close_to_scale(S_b, S_whole)


def _step_scan_float64(S, r, k, v, w, u):
    """The recurrence step by step in numpy float64: (out, S_T)."""
    outs = []
    for t in range(r.shape[1]):
        kv = np.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        outs.append(np.einsum("bhk,bhkv->bhv", r[:, t], S + u[None, :, :, None] * kv))
        S = S * w[:, t, ..., None] + kv
    return np.stack(outs, axis=1), S


@pytest.mark.parametrize("w_range", [(0.05, 0.999), (1e-8, 1e-8)])  # and at the clamp
def test_chunked_ref_in_float64_matches_a_float64_step_scan(w_range):
    """``precision=torch.float64``, the yardstick of the card's clamp case:
    a ragged T from a state, against the step scan in float64, rounded
    once to float32 (out in out_dtype, S_T float32)."""
    rng = np.random.default_rng(12)
    B, T, H, hs = 2, 150, 2, 16
    r, v = rng.normal(size=(2, B, T, H, hs))
    k = rng.normal(size=(B, T, H, hs)) * 0.5
    w = rng.uniform(*w_range, size=(B, T, H, hs))
    u = rng.normal(size=(H, hs)) * 0.3
    S0 = rng.normal(size=(B, H, hs, hs)) * 0.5
    want, want_S = _step_scan_float64(S0, r, k, v, w, u)
    got, got_S = wkv6_chunked_ref(*(torch.from_numpy(a) for a in (r, k, v, w, u)),
                                  state=torch.from_numpy(S0), out_dtype=torch.float32,
                                  precision=torch.float64)
    assert got.dtype == torch.float32 and got_S.dtype == torch.float32
    for g, x in ((got, want), (got_S, want_S)):
        np.testing.assert_allclose(g.numpy(), x, rtol=1e-6, atol=1e-6 * np.abs(x).max())


def _pair(**overrides):
    """(reference cfg, reference params, port cfg, port model) with one set of weights."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **overrides)
    cfg = dataclasses.replace(smoke_config(ARCH), **overrides)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    model = tf.Transformer(cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(jax.tree.map(np.asarray, params)))
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _tokens(seed, B, S, vocab):
    t = np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t.astype(np.int64))


def _state_pair(jcfg, cfg, B, seed, dtype):
    """The same random non-zero RWKV state for both packages."""
    rng = np.random.default_rng(seed)
    d, hs = cfg.d_model, cfg.rwkv_head_size
    arrays = {"S": rng.normal(size=(B, d // hs, hs, hs)).astype(np.float32) * 0.3,
              "x_prev_tm": rng.normal(size=(B, d)).astype(np.float32),
              "x_prev_cm": rng.normal(size=(B, d)).astype(np.float32)}
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jstate = {k: jnp.asarray(a, jnp.float32 if k == "S" else jdt) for k, a in arrays.items()}
    state = {k: torch.from_numpy(np.array(jstate[k].astype(jnp.float32))).to(
        torch.float32 if k == "S" else dtype) for k in arrays}
    return jstate, state


@pytest.mark.parametrize("S", [12, 1])  # ragged against chunk 64; one decode step
@pytest.mark.parametrize("mix", ["time", "channel"])
def test_mix_matches_reference(pair, S, mix):
    jcfg, params, cfg, model = pair
    jp = jax.tree.map(lambda a: a[1], params["blocks"]["pos0"]["rwkv"])  # layer 1
    p = model.blocks[1].rwkv
    x = np.random.default_rng(S).normal(size=(2, S, cfg.d_model)).astype(np.float32)
    jstate, state = _state_pair(jcfg, cfg, 2, S + 1, torch.bfloat16)
    fns = {"time": (jssm.rwkv_time_mix, ssm.rwkv_time_mix),
           "channel": (jssm.rwkv_channel_mix, ssm.rwkv_channel_mix)}[mix]
    want, jnew = jax.jit(lambda x, p, s: fns[0](x, p, jcfg, s))(jnp.asarray(x), jp, jstate)
    got, new = fns[1](torch.from_numpy(x), p, cfg, state)
    assert got.shape == (2, S, cfg.d_model)
    assert got.dtype == (torch.bfloat16 if mix == "time" else torch.float32)
    _close(got, want)
    for key in ("S", "x_prev_tm", "x_prev_cm"):
        assert new[key].dtype == state[key].dtype
        _close(new[key], jnew[key], 1e-5 if key == "S" else 0)


def test_weights_carried_across(pair):
    jcfg, params, cfg, model = pair
    assert len(model.blocks) == cfg.n_layers == 2
    assert isinstance(model.blocks[0], tf.RWKVBlock)
    np.testing.assert_array_equal(model.blocks[1].rwkv.cm_v.detach().numpy(),
                                  np.asarray(params["blocks"]["pos0"]["rwkv"]["cm_v"][1]))
    np.testing.assert_array_equal(model.blocks[0].norm2.detach().numpy(),
                                  np.asarray(params["blocks"]["pos0"]["norm2"]["w"][0]))
    np.testing.assert_array_equal(model.lm_head.detach().numpy(), np.asarray(params["lm_head"]))


@pytest.mark.parametrize("S", [24, 100])  # one ragged chunk; two chunks of 64
def test_forward_matches_reference(pair, S):
    jcfg, params, cfg, model = pair
    jt, tt = _tokens(S, 2, S, cfg.vocab_size)
    want, _ = jtf.forward(params, jcfg, {"tokens": jt})
    got, _ = tf.forward(model, cfg, {"tokens": tt})
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _close(got, want)


@pytest.mark.parametrize("logits_chunk", [0, 8])
def test_loss_matches_reference(pair, logits_chunk):
    jcfg, params, cfg, model = pair
    jt, tt = _tokens(2, 2, 24, cfg.vocab_size)
    want = jtf.loss_fn(params, jcfg, {"tokens": jt}, logits_chunk=logits_chunk)
    got = tf.loss_fn(model, cfg, {"tokens": tt}, logits_chunk=logits_chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
def test_decode_teacher_forced_matches_reference(pair, cache_dtype):
    """Prefill 8 tokens, then 4 single steps, the same tokens into both;
    the carried states agree after every call."""
    jcfg, params, cfg, model = pair
    B, S, k = 2, 12, 8
    jt, tt = _tokens(4, B, S, cfg.vocab_size)
    jdt = jnp.bfloat16 if cache_dtype == torch.bfloat16 else jnp.float32
    jstate = jtf.init_decode_state(jcfg, B, 16, cache_dtype=jdt)
    state = tf.init_decode_state(cfg, B, 16, cache_dtype=cache_dtype, device="cpu")
    for s0, s1 in [(0, k)] + [(i, i + 1) for i in range(k, S)]:
        want, jstate = jtf.decode_step(params, jcfg, jstate, {"tokens": jt[:, s0:s1]})
        got, state = tf.decode_step(model, cfg, state, {"tokens": tt[:, s0:s1]})
        _close(got, want)
        for i, st in enumerate(state.layers):
            jst = jax.tree.map(lambda a: a[i], jstate["layers"]["pos0"]["rwkv"])
            assert st["x_prev_tm"].dtype == cache_dtype and st["S"].dtype == torch.float32
            _close(st["S"], jst["S"])
    assert state.pos == int(jstate["pos"]) == S


def test_decode_matches_forward_with_f32_state(pair):
    """The reference's decode-vs-forward check on the port."""
    _, _, cfg, model = pair
    _, tt = _tokens(6, 2, 12, cfg.vocab_size)
    full, _ = tf.forward(model, cfg, {"tokens": tt})
    state = tf.init_decode_state(cfg, 2, 12, cache_dtype=torch.float32, device="cpu")
    logits, state = tf.decode_step(model, cfg, state, {"tokens": tt[:, :8]})
    _close(logits[:, -1], full[:, 7])
    for i in range(8, 12):
        logits, state = tf.decode_step(model, cfg, state, {"tokens": tt[:, i:i + 1]})
        _close(logits[:, 0], full[:, i])


def test_serve_module_runs_rwkv_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--requests", "4"], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "predicted max batch" in res.stdout and "4/4 done" in res.stdout


def test_deep_model_within_its_own_floor_of_the_reference():
    """At 16 layers the model amplifies a float32-sized change: the
    reference's own logits move by more than 0.1 when w0 moves by 2^-20.
    The port stays within twice that floor of the reference, the bound
    ``chip_smoke.py`` holds the 32-layer logits to on the card."""
    jcfg, params, cfg, model = _pair(n_layers=16)
    jt, tt = _tokens(10, 2, 64, cfg.vocab_size)
    want = np.asarray(jtf.forward(params, jcfg, {"tokens": jt})[0], np.float32)
    nudged = jax.tree.map(lambda a: a, params)
    rwkv = nudged["blocks"]["pos0"]["rwkv"]
    rwkv["w0"] = rwkv["w0"] * (1 + 2**-20)
    floor = np.abs(np.asarray(jtf.forward(nudged, jcfg, {"tokens": jt})[0], np.float32)
                   - want).max()
    got = tf.forward(model, cfg, {"tokens": tt})[0].detach().float().numpy()
    assert floor > 0.1
    assert np.abs(got - want).max() <= 2 * floor
