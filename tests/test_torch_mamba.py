"""The port's Mamba block and jamba-v0.1-52b against the reference, on the CPU.

``repro_torch.models.ssm``'s Mamba half against ``repro.models.ssm`` on the
reference's weights and numpy inputs:

* the chunk scan against ``jax.lax.associative_scan`` with the reference's
  combine, and ``_selective_scan_chunked`` against the reference's at
  ragged lengths across chunks;
* ``mamba_block`` from a carried state (a 10-token call, then one step),
  its output and its state (``h``, the conv tail): float32 to 1e-5,
  bfloat16 to 2e-2 against ``jax.jit`` of the reference's block;
* a decode step (S = 1) is one recurrence step: no tensor of it is as big
  as the 256-step chunk the reference pads it to, and it agrees with the
  reference's padded step;
* jamba-v0.1-52b's smoke config (16 layers: 14 Mamba, 2 attention, MoE on
  the odd positions): logits and the aux, the loss with the aux,
  teacher-forced decode through the Mamba and attention states with
  ``n_groups`` 16 (16 groups at the prefill's B S = 16, one at a decode
  step's B = 2) and every layer's state after it, the params through
  ``convert`` both ways, and the server's greedy tokens against the
  port's own forward;
* every gradient leaf against ``jax.value_and_grad`` of the reference's
  loss on jamba's smoke widths cut to one layer, a Mamba block with MoE:
  the reference compiles one scan body per period, on a CPU about 17 s for
  jamba's eight positions against 6 s for two Mamba blocks.

Float32 results agree to 1e-5 of the largest value (logits, each gradient
leaf), as ``tests/test_torch_train.py`` holds gradients: sixteen layers of
float32 rounding leave the reference's own two evaluation orders (its
scanned layers and ``unroll_layers=True``) 1.2e-5 apart elementwise.  In
bfloat16 the same config amplifies any rounding: the reference's own
logits move by 1.16 between those orders and lie 0.64 from its float32
logits.  So bfloat16 logits are held to the reference's own bfloat16
distance from float32 (relative norm, x1.5), as RWKV's bfloat16 gradients
are there; the bfloat16 loss with the aux, an average, to 2e-2.

The weights are drawn by the port from a seed and carried to the
reference by ``convert.lm_params_to_reference``; the reference's calls are
compiled once per shape (``jax.jit``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import smoke_config as jax_smoke_config
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch.configs import smoke_config
from repro_torch.convert import lm_params_from_reference, lm_params_to_reference
from repro_torch.launch.serve import BatchedServer
from repro_torch.models import ssm
from repro_torch.models import transformer as tf

JAMBA = "jamba-v0.1-52b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: bfloat16 logits: within this factor of the reference's own distance
#: from its float32 logits (relative norm)
BF16_NOISE_FACTOR = 1.5
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _rel(got, want) -> float:
    """Largest difference over the largest value of ``want``."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def _combine(x, y):
    return x[0] * y[0], y[0] * x[1] + y[1]


@pytest.mark.parametrize("n", [1, 2, 5, 13])
def test_scan_chunk_matches_associative_scan(n):
    """Odd and even lengths at every level of the recursion (13 -> 6 -> 3 -> 1)."""
    a = _rng(n).uniform(0.5, 1.0, size=(2, n, 3, 4)).astype(np.float32)
    b = _rng(n + 1).normal(size=(2, n, 3, 4)).astype(np.float32)
    want = jax.jit(functools.partial(jax.lax.associative_scan, _combine, axis=1))(
        (jnp.asarray(a), jnp.asarray(b)))
    got = ssm._scan_chunk(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


@pytest.mark.parametrize("S,chunk", [(1, 256), (20, 8), (24, 8)])
def test_selective_scan_matches_reference(S, chunk):
    """Ragged (20) and whole (24) chunks of 8, and one step; from a
    non-zero state."""
    r = _rng(S)
    h0 = r.normal(size=(2, 8, 4)).astype(np.float32)
    dt = r.uniform(0.001, 0.1, size=(2, S, 8)).astype(np.float32)
    dtx = (dt * r.normal(size=(2, S, 8))).astype(np.float32)
    A = -np.exp(r.normal(size=(8, 4))).astype(np.float32)
    Bs, Cs = (r.normal(size=(2, S, 4)).astype(np.float32) for _ in range(2))
    args = (h0, dt, dtx, A, Bs, Cs)
    want_y, want_h = jax.jit(jssm._selective_scan_chunked, static_argnums=6)(
        *map(jnp.asarray, args), chunk)
    y, h = ssm._selective_scan_chunked(*map(torch.from_numpy, args), chunk)
    _close(y, want_y, 1e-5)
    _close(h, want_h, 1e-5)


@functools.cache
def _block_pair(dtype):
    jcfg, cfg = (dataclasses.replace(c, compute_dtype=dtype)
                 for c in (jax_smoke_config(JAMBA), smoke_config(JAMBA)))
    p = ssm.Mamba(cfg, torch.float32, "cpu", torch.Generator().manual_seed(1))
    params = {k: jnp.asarray(v.detach().numpy()) for k, v in p.named_parameters()}
    return jcfg, params, cfg, p, jax.jit(lambda x, s: jssm.mamba_block(x, params, jcfg, s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_with_carried_state_matches_reference(dtype):
    """From a random state (``h`` and the conv tail), a 10-token call, then
    one decode step from the state it left: outputs, ``h`` and the conv
    tail."""
    jcfg, params, cfg, p, jblock = _block_pair(dtype)
    r = _rng(3)
    x = r.normal(size=(2, 11, 64)).astype(np.float32)
    h0 = r.normal(size=(2, 2 * 64, cfg.mamba_d_state)).astype(np.float32)
    conv0 = r.normal(size=(2, 3, 2 * 64)).astype(np.float32)
    jstate = {"h": jnp.asarray(h0), "conv": jnp.asarray(conv0, DTYPES[dtype][0])}
    state = {"h": torch.from_numpy(h0), "conv": torch.from_numpy(conv0).to(DTYPES[dtype][1])}
    tol = TOL[dtype]
    for s0, s1 in ((0, 10), (10, 11)):
        want, jstate = jblock(jnp.asarray(x[:, s0:s1], DTYPES[dtype][0]), jstate)
        with torch.no_grad():
            got, state = ssm.mamba_block(torch.from_numpy(x[:, s0:s1]).to(DTYPES[dtype][1]),
                                         p, cfg, state)
        assert got.dtype == DTYPES[dtype][1] and state["conv"].dtype == DTYPES[dtype][1]
        _close(got, want, tol)
        _close(state["h"], jstate["h"], tol)
        _close(state["conv"], jstate["conv"], tol)


class _Sizes(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.shapes += [tuple(t.shape) for t in jax.tree.leaves(out)
                        if isinstance(t, torch.Tensor)]
        return out


def test_decode_step_is_one_recurrence_step():
    """At S = 1 the reference scans a chunk of 256 steps, 255 of them
    identity steps; the port takes one step, so none of its tensors is as
    big as a padded chunk's (B, 256, d_in, d_state), and the result is the
    same function (float32, 1e-6)."""
    jcfg, params, cfg, p, jblock = _block_pair("float32")
    d_in, ds = 2 * 64, cfg.mamba_d_state
    r = _rng(4)
    h = r.normal(size=(2, d_in, ds)).astype(np.float32)
    conv = r.normal(size=(2, 3, d_in)).astype(np.float32)
    x = r.normal(size=(2, 1, 64)).astype(np.float32)
    want, jstate = jblock(jnp.asarray(x), {"h": jnp.asarray(h), "conv": jnp.asarray(conv)})
    with torch.no_grad(), _Sizes() as sizes:
        got, state = ssm.mamba_block(torch.from_numpy(x), p, cfg,
                                     {"h": torch.from_numpy(h), "conv": torch.from_numpy(conv)})
    assert max(int(np.prod(s)) for s in sizes.shapes) < 2 * 256 * d_in * ds // 16
    _close(got, want, 1e-6)
    _close(state["h"], jstate["h"], 1e-6)


def test_init_mamba_shapes_and_dtypes():
    cfg = smoke_config(JAMBA)
    d_in, ds = 2 * 64, cfg.mamba_d_state
    w = ssm.init_mamba(cfg, torch.bfloat16, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in w.items()} == {
        "in_proj": (64, 2 * d_in), "conv_w": (4, d_in), "conv_b": (d_in,),
        "x_proj": (d_in, 2 * ds + 1), "dt_bias": (d_in,), "A_log": (d_in, ds), "D": (d_in,),
        "out_proj": (d_in, 64)}
    assert w["A_log"].dtype == torch.float32 and w["in_proj"].dtype == torch.bfloat16
    torch.testing.assert_close(w["A_log"][3], torch.log(torch.arange(1.0, ds + 1)))
    assert float(w["dt_bias"][0]) == pytest.approx(-4.6, abs=0.02)
    with pytest.raises(ValueError, match="generator on"):
        ssm.init_mamba(cfg, torch.float32, torch.Generator().manual_seed(0), "meta")


# ---------------------------------------------------------------- jamba

@functools.cache
def _weights(over=(), **moe_over):
    """The port's smoke-config weights from seed 0 (state dict) and the same
    as the reference's pytree (numpy)."""
    cfg = smoke_config(JAMBA)
    cfg = dataclasses.replace(cfg, **dict(over), moe=dataclasses.replace(cfg.moe, **moe_over))
    state = tf.init_params(cfg, seed=0, device="cpu").state_dict()
    return state, lm_params_to_reference(cfg, state)


@functools.cache
def _pair(dtype, over=(), **moe_over):
    """(reference cfg, reference params, numpy params, port cfg, port model)
    at ``dtype`` with the config fields ``over`` and MoE fields
    ``moe_over`` replaced, on one set of weights."""
    jcfg, cfg = (dataclasses.replace(c, compute_dtype=dtype, **dict(over),
                                     moe=dataclasses.replace(c.moe, **moe_over))
                 for c in (jax_smoke_config(JAMBA), smoke_config(JAMBA)))
    placement = {k: v for k, v in moe_over.items() if k in ("every_n_layers", "offset")}
    state, np_params = _weights(over, **placement)
    model = tf.Transformer(cfg, device="cpu")
    model.load_state_dict(state)
    return jcfg, jax.tree.map(jnp.asarray, np_params), np_params, cfg, model


def _tokens(seed, B=2, S=24):
    t = _rng(seed).integers(0, 512, size=(B, S)).astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t.astype(np.int64))


@functools.cache
def _jax_forward(dtype):
    jcfg, params, *_ = _pair(dtype)
    logits, aux = jax.jit(functools.partial(jtf.forward, cfg=jcfg))(
        params, batch={"tokens": _tokens(1)[0]})
    return np.asarray(logits, np.float32), float(aux)


def _rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_jamba_layout():
    *_, cfg, model = _pair("float32")
    kinds = [type(b).__name__ for b in model.blocks]
    assert kinds == ["MambaBlock"] * 4 + ["Block"] + ["MambaBlock"] * 7 + ["Block"] + \
        ["MambaBlock"] * 3
    assert [b.moe is not None for b in model.blocks] == [i % 2 == 1 for i in range(16)]
    state = tf.init_decode_state(cfg, 2, 16, cache_dtype=torch.bfloat16, device="cpu")
    assert state.layers[0]["h"].dtype == torch.float32
    assert tuple(state.layers[0]["conv"].shape) == (2, 3, 128)
    assert state.layers[0]["conv"].dtype == torch.bfloat16
    assert isinstance(state.layers[4], tuple)


def test_forward_and_loss_with_aux_match_reference_float32():
    *_, cfg, model = _pair("float32")
    want, jaux = _jax_forward("float32")
    with torch.no_grad():
        got, aux = tf.forward(model, cfg, {"tokens": _tokens(1)[1]})
    assert got.dtype == torch.float32
    assert _rel(got, want) <= TOL["float32"]
    assert float(aux) == pytest.approx(jaux, abs=1e-6)
    # the loss: the reference's logits' next-token cross-entropy (float64)
    # plus router_aux_weight times its aux
    want_loss = (_cross_entropy(want, np.asarray(_tokens(1)[0]))
                 + cfg.moe.router_aux_weight * jaux)
    with torch.no_grad():
        loss = tf.loss_fn(model, cfg, {"tokens": _tokens(1)[1]})
    assert float(loss) == pytest.approx(want_loss, rel=TOL["float32"])


def _cross_entropy(logits, tokens) -> float:
    """Next-token cross-entropy of float32 logits, in float64."""
    logits = logits[:, :-1].astype(np.float64)
    m = logits.max(-1, keepdims=True)
    logz = (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., 0]
    gold = np.take_along_axis(logits, tokens[:, 1:, None], -1)[..., 0]
    return float((logz - gold).mean())


def test_forward_bfloat16_within_the_reference_own_rounding():
    """bfloat16 logits: the port's distance from the reference's is at most
    1.5x the reference's own bfloat16-to-float32 distance; the aux, and
    the loss with the aux, to 2e-2."""
    *_, cfg, model = _pair("bfloat16")
    want, jaux = _jax_forward("bfloat16")
    exact, _ = _jax_forward("float32")
    with torch.no_grad():
        got, aux = tf.forward(model, cfg, {"tokens": _tokens(1)[1]})
        loss = tf.loss_fn(model, cfg, {"tokens": _tokens(1)[1]})
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert _rel_norm(got, want) <= BF16_NOISE_FACTOR * _rel_norm(want, exact)
    assert _rel_norm(got, exact) <= BF16_NOISE_FACTOR * _rel_norm(want, exact)
    assert float(aux) == pytest.approx(jaux, abs=TOL["bfloat16"])
    want_loss = (_cross_entropy(want, np.asarray(_tokens(1)[0]))
                 + cfg.moe.router_aux_weight * jaux)
    assert float(loss) == pytest.approx(want_loss, rel=TOL["bfloat16"])


def test_loss_with_aux_and_gradients_match_reference():
    """float32, jamba's widths cut to one layer, a Mamba block with MoE
    (the dense FFN's gradients are granite's and qwen3's tests'): the loss
    with the aux, and every gradient leaf (the Mamba block's, the router's
    and the experts' included) against ``jax.value_and_grad`` of the
    reference's loss."""
    jcfg, params, _, cfg, model = _pair(
        "float32", over=(("block_pattern", ("mamba",)), ("n_layers", 1)), every_n_layers=1,
        offset=0)
    jt, tt = _tokens(2)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        functools.partial(jtf.loss_fn, cfg=jcfg)))(params, batch={"tokens": jt})
    loss = tf.loss_fn(model, cfg, {"tokens": tt})
    assert float(loss) == pytest.approx(float(want_loss), rel=TOL["float32"])
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    want = lm_params_from_reference(jax.tree.map(np.asarray, want_grads))
    assert set(grads) == set(want)
    assert any(".mamba.A_log" in n for n in grads) and any(".moe.router" in n for n in grads)
    worst = max((_rel(grads[n], want[n].numpy()), n) for n in want)
    assert worst[0] <= TOL["float32"], worst


def test_decode_teacher_forced_matches_reference():
    """float32: prefill 8 tokens, then 4 single steps through the Mamba
    states and the attention caches, the same tokens into both packages:
    logits at each call, and every layer's state at the end (Mamba's ``h``
    and conv tail, the attention caches).  At ``n_groups`` 16 the
    prefill's 16 tokens dispatch in 16 groups and each step's 2 in one."""
    jcfg, params, _, cfg, model = _pair("float32", n_groups=16)
    jt, tt = _tokens(4, 2, 12)
    jstate = jtf.init_decode_state(jcfg, 2, 16, cache_dtype=jnp.float32)
    state = tf.init_decode_state(cfg, 2, 16, cache_dtype=torch.float32, device="cpu")
    step = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg))
    for s0, s1 in [(0, 8)] + [(i, i + 1) for i in range(8, 12)]:
        want, jstate = step(params, state=jstate, batch={"tokens": jt[:, s0:s1]})
        got, state = tf.decode_step(model, cfg, state, {"tokens": tt[:, s0:s1]})
        assert _rel(got, want) <= TOL["float32"]
    assert state.pos == int(jstate["pos"]) == 12
    for i, layer in enumerate(state.layers):
        ref = jstate["layers"][f"pos{i % 8}"]
        want = ([ref["mamba"]["h"], ref["mamba"]["conv"]] if isinstance(layer, dict)
                else [ref["kv"]["k"], ref["kv"]["v"]])
        got = [layer["h"], layer["conv"]] if isinstance(layer, dict) else layer
        for g, w in zip(got, want):
            assert _rel(g, w[i // 8]) <= TOL["float32"], i


def test_params_cross_both_ways():
    """The port's state dict -> the reference's pytree (the tree, shapes and
    dtypes of the reference's ``init_params``) -> the port's -> the
    reference's, leaf for leaf."""
    *_, np_params, cfg, _ = _pair("float32")
    ref = jax.eval_shape(functools.partial(jtf.init_params, jax_smoke_config(JAMBA)),
                         jax.random.PRNGKey(0))
    assert jax.tree.structure(np_params) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(np_params), jax.tree.leaves(ref)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    back = lm_params_to_reference(cfg, lm_params_from_reference(np_params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a, b)


def test_server_tokens_follow_the_forward_pass():
    """``BatchedServer`` on the smoke config: each greedy token is the
    argmax of a plain forward over the prompt and the tokens before it,
    wherever that argmax leads its runner-up by more than 0.1 (and every
    earlier token agreed), so the carried Mamba and attention states are
    the prompt's."""
    *_, cfg, model = _pair("bfloat16")
    prompts = torch.from_numpy(_rng(5).integers(0, 512, size=(3, 8)))
    with torch.no_grad():
        tokens, dt = BatchedServer(cfg, model, max_len=32).serve(prompts, 6)
        logits, _ = tf.forward(model, cfg, {"tokens": torch.cat([prompts, tokens], 1)})
    assert tokens.shape == (3, 6) and dt > 0
    logits = logits[:, 7:-1].float()
    top2 = logits.topk(2, dim=-1).values
    checked = 0
    for b in range(3):
        for t in range(6):
            if float(top2[b, t, 0] - top2[b, t, 1]) <= 0.1:
                break
            assert int(tokens[b, t]) == int(logits[b, t].argmax()), (b, t)
            checked += 1
    assert checked > 0
