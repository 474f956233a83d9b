"""The port's MoE FFN and the MoE models against the reference, on the CPU.

``repro_torch.models.moe`` against ``repro.models.moe`` on the same
weights (the reference's ``init_moe``) and the same numpy inputs:

* ``moe_ffn`` (sort-based, token-major) and ``moe_ffn_grouped`` (GShard
  cumsum, k-major) at the smoke's capacity factor 8.0 (nothing drops) and
  at 1.0 (tokens drop), at ``n_groups`` 4 and with B S not a multiple of
  it (one group).  The drop set is read off each package's output: every
  token's output is the sum of its kept choices' gated expert outputs, so
  the subset of its K choices that explains it is the set it kept; both
  packages' subsets must be the same, bit for bit.  Outputs agree to 1e-5
  in float32 and 2e-2 in bfloat16, the aux to 1e-6.
* The port's grouped dispatch builds no (G, T, E, C) tensor.
* granite-moe-1b-a400m and arctic-480b (dense-residual FFN beside the MoE)
  at their smoke configs: logits, the aux summed over layers, the loss with
  ``router_aux_weight * aux``, every gradient leaf (float32, 1e-5 of the
  leaf's largest value), teacher-forced decode, three train steps, and the
  params and AdamW state through ``convert`` both ways.

The weights are drawn by the port from a seed and carried to the
reference by ``convert.lm_params_to_reference``; the reference's calls are
compiled once per shape (``jax.jit``), since compilation is most of each
test's cost.
"""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import smoke_config as jax_smoke_config
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.train import StepConfig as JaxStepConfig
from repro.train import build_train_step as jax_build_train_step
from repro_torch.configs import smoke_config
from repro_torch.convert import (
    adamw_state_from_reference,
    adamw_state_to_reference,
    lm_params_from_reference,
    lm_params_to_reference,
)
from repro_torch.models import moe
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.train import StepConfig, build_train_step

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AUX_TOL = 1e-6
GRANITE, ARCTIC = "granite-moe-1b-a400m", "arctic-480b"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch=GRANITE, compute_dtype="bfloat16", **moe_over):
    """(reference cfg, port cfg), the smoke config with ``compute_dtype`` and
    the MoE fields in ``moe_over`` replaced."""
    out = []
    for get in (jax_smoke_config, smoke_config):
        cfg = get(arch)
        out.append(dataclasses.replace(cfg, compute_dtype=compute_dtype,
                                       moe=dataclasses.replace(cfg.moe, **moe_over)))
    return tuple(out)


@pytest.fixture(scope="module")
def layer():
    """One MoE layer's reference weights (numpy) and the port's tensors."""
    jcfg, _ = _cfgs()
    params = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32))
    return params, {k: torch.from_numpy(v) for k, v in params.items()}


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _silu(z):
    return z / (1 + np.exp(-z))


def _kept(x, y, params, cfg):
    """(T, K) kept choices that explain y (T, D): per token, the subset of
    its K routed choices whose gated expert outputs (float64) sum closest
    to its output row; and the worst such distance."""
    m = cfg.moe
    x = x.astype(np.float64)
    logits = x @ params["router"].astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :m.top_k]
    gates = np.take_along_axis(probs, idx, -1)
    gates /= gates.sum(-1, keepdims=True)
    wg, wu, wd = (params[k].astype(np.float64) for k in ("w_gate", "w_up", "w_down"))
    contrib = np.stack([gates[:, k, None] * np.einsum(
        "tf,tfd->td", _silu(np.einsum("td,tdf->tf", x, wg[idx[:, k]]))
        * np.einsum("td,tdf->tf", x, wu[idx[:, k]]), wd[idx[:, k]]) for k in range(m.top_k)], 1)
    subsets = np.array(list(itertools.product([False, True], repeat=m.top_k)))
    resid = np.abs(y.astype(np.float64)[:, None] - np.einsum("sk,tkd->tsd", subsets, contrib))
    best = resid.max(-1).argmin(-1)
    return subsets[best], float(resid.max(-1).min(-1).max())


def _compare(got, aux, want, jaux, dtype, x, params, cfg, drops: bool):
    y, w = got.detach().float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(y, w, rtol=TOL[dtype], atol=TOL[dtype])
    assert float(aux) == pytest.approx(float(jaux), abs=AUX_TOL)
    if dtype != "float32":
        return
    kept, resid = _kept(x, y, params, cfg)
    want_kept, want_resid = _kept(x, w, params, cfg)
    assert resid < 1e-4 and want_resid < 1e-4
    np.testing.assert_array_equal(kept, want_kept)
    assert (not kept.all()) == drops
    return kept


@functools.cache
def _jax_moe(fn, cf, n_groups, dtype):
    jcfg, _ = _cfgs(capacity_factor=cf, n_groups=n_groups)
    return jax.jit(lambda x, p: getattr(jmoe, fn)(x, p, jcfg, DTYPES[dtype][0]))


@pytest.mark.parametrize("cf,dtype", [(8.0, "float32"), (1.0, "float32"), (1.0, "bfloat16")])
def test_moe_ffn_matches_reference(cf, dtype, layer):
    """The sort-based dispatch of one (T, D) group."""
    params, tparams = layer
    _, cfg = _cfgs(capacity_factor=cf)
    x = _x(1, 48, 64)
    want, jaux = _jax_moe("moe_ffn", cf, 1, dtype)(jnp.asarray(x), params)
    got, aux = moe.moe_ffn(torch.from_numpy(x), tparams, cfg, DTYPES[dtype][1])
    assert got.dtype == DTYPES[dtype][1] and aux.dtype == torch.float32
    _compare(got, aux, want, jaux, dtype, x, params, cfg, drops=cf == 1.0)


GROUPED = [(8.0, 1, 24), (1.0, 1, 24), (1.0, 4, 24), (1.0, 4, 23)]


@pytest.mark.parametrize("cf,n_groups,S,dtype", [g + ("float32",) for g in GROUPED] + [
    g + ("bfloat16",) for g in GROUPED[2:]])
def test_moe_ffn_grouped_matches_reference(cf, n_groups, S, dtype, layer):
    """k-major positions in G groups; B S = 46 is no multiple of 4, so the
    last case runs as one group, as in the reference."""
    params, tparams = layer
    _, cfg = _cfgs(capacity_factor=cf, n_groups=n_groups)
    x = _x(2, 2, S, 64)
    want, jaux = _jax_moe("moe_ffn_grouped", cf, n_groups, dtype)(jnp.asarray(x), params)
    got, aux = moe.moe_ffn_grouped(torch.from_numpy(x), tparams, cfg, DTYPES[dtype][1])
    assert got.shape == (2, S, 64) and got.dtype == DTYPES[dtype][1]
    a = moe.assign(torch.from_numpy(x), tparams["router"], cfg)
    assert a.G == (n_groups if (2 * S) % n_groups == 0 else 1)
    assert a.cap == moe.capacity(a.T, cfg)
    kept = _compare(got.reshape(-1, 64), aux, np.asarray(want, np.float32).reshape(-1, 64),
                    jaux, dtype, x.reshape(-1, 64), params, cfg, drops=cf == 1.0)
    if kept is not None:  # the Assignment's keep is the set the output shows
        np.testing.assert_array_equal(a.keep.reshape(-1, cfg.moe.top_k).numpy(), kept)


def test_groups_change_the_drop_set(layer):
    """At capacity factor 1.0 four groups of 12 tokens keep other slots than
    one group of 48 (the capacity is a group's)."""
    _, tparams = layer
    x = torch.from_numpy(_x(2, 2, 24, 64))
    keeps = [moe.assign(x, tparams["router"], _cfgs(capacity_factor=1.0, n_groups=g)[1]).keep
             for g in (1, 4)]
    assert not torch.equal(keeps[0].reshape(-1), keeps[1].reshape(-1))


class _Sizes(TorchDispatchMode):
    """Records the element count of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.numels = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.numels += [t.numel() for t in jax.tree.leaves(out) if isinstance(t, torch.Tensor)]
        return out


def test_grouped_dispatch_builds_no_token_expert_slot_tensor(layer):
    """At T = 512 tokens, E = 4 and C = 512 slots the reference's dispatch
    and combine tensors hold G T E C = 2**20 elements; the port's largest
    are the experts' hidden (E, C, f) and their output rows with one spare
    (E C + 1, D), about 8x smaller."""
    _, tparams = layer
    _, cfg = _cfgs(capacity_factor=8.0)
    x = torch.from_numpy(_x(3, 2, 256, 64))
    a = moe.assign(x, tparams["router"], cfg)
    gtec = a.G * a.T * cfg.moe.n_experts * a.cap
    assert gtec == 2**20
    with torch.no_grad(), _Sizes() as sizes:
        moe.moe_ffn_grouped(x, tparams, cfg)
    assert max(sizes.numels) < gtec // 4


def test_init_moe_shapes_scales_and_device():
    _, cfg = _cfgs()
    m = cfg.moe
    w = moe.init_moe(cfg, torch.bfloat16, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in w.items()} == {
        "router": ((64, m.n_experts), torch.float32),
        "w_gate": ((m.n_experts, 64, m.d_ff_expert), torch.bfloat16),
        "w_up": ((m.n_experts, 64, m.d_ff_expert), torch.bfloat16),
        "w_down": ((m.n_experts, m.d_ff_expert, 64), torch.bfloat16)}
    for name, fan_in in (("router", 64), ("w_gate", 64), ("w_down", m.d_ff_expert)):
        assert float(w[name].float().std()) == pytest.approx(fan_in**-0.5, rel=0.1)
    with pytest.raises(ValueError, match="generator on"):
        moe.init_moe(cfg, torch.float32, torch.Generator().manual_seed(0), "meta")


# --------------------------------------------------------------- the models

@functools.cache
def _pair(arch, compute_dtype):
    """(reference cfg, reference params, the same as numpy, port cfg, port
    model): weights drawn by the port from seed 0 and carried over."""
    jcfg, cfg = (dataclasses.replace(c, compute_dtype=compute_dtype)
                 for c in (jax_smoke_config(arch), smoke_config(arch)))
    model = tf.init_params(cfg, seed=0, device="cpu")
    np_params = lm_params_to_reference(cfg, model.state_dict())
    return jcfg, jax.tree.map(jnp.asarray, np_params), np_params, cfg, model


@pytest.fixture(scope="module")
def models():
    return _pair


@functools.cache
def _jax_fn(name, arch, compute_dtype, **kw):
    """``jax.jit`` of the reference's ``transformer.<name>`` at this config."""
    jcfg = _pair(arch, compute_dtype)[0]
    return jax.jit(functools.partial(getattr(jtf, name), cfg=jcfg, **kw))


def _tokens(seed, B=2, S=24, vocab=512):
    t = np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t.astype(np.int64))


@functools.cache
def _jax_loss_and_grads(arch, compute_dtype, seed):
    jcfg, params, *_ = _pair(arch, compute_dtype)
    jt, _ = _tokens(seed)
    f = jax.jit(jax.value_and_grad(functools.partial(jtf.loss_fn, cfg=jcfg)))
    loss, grads = f(params, batch={"tokens": jt})
    return float(loss), jax.tree.map(np.asarray, grads)


def _rel(got, want) -> float:
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [GRANITE, ARCTIC])
def test_forward_and_aux_match_reference(arch, dtype, models):
    """Logits to the LM tolerance; the aux (summed over the layers) to
    1e-6 in float32 and to the logits' tolerance in bfloat16, where the
    router sees activations rounded apart."""
    _, params, _, cfg, model = models(arch, dtype)
    jt, tt = _tokens(1)
    want, jaux = _jax_fn("forward", arch, dtype)(params, batch={"tokens": jt})
    got, aux = tf.forward(model, cfg, {"tokens": tt})
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])
    assert float(aux) > 0
    assert float(aux) == pytest.approx(float(jaux),
                                       abs=AUX_TOL if dtype == "float32" else TOL[dtype])


def test_moe_aux_loss_present():
    """The counterpart of tests/test_models_smoke.py's: the port's own
    weights give a positive aux."""
    cfg = smoke_config(GRANITE)
    model = tf.init_params(cfg, seed=4, device="cpu")
    _, aux = tf.forward(model, cfg, {"tokens": torch.zeros((2, 16), dtype=torch.long)})
    assert float(aux) > 0.0


@pytest.mark.parametrize("arch", [GRANITE, ARCTIC])
def test_loss_with_aux_and_gradients_match_reference(arch, models):
    """float32: the loss (cross-entropy plus router_aux_weight * aux) and
    every gradient leaf, the router's and the experts' included, against
    ``jax.value_and_grad`` of the reference's loss, to 1e-5 of each leaf's
    largest value."""
    *_, cfg, model = models(arch, "float32")
    want_loss, want_grads = _jax_loss_and_grads(arch, "float32", 2)
    _, tt = _tokens(2)
    loss = tf.loss_fn(model, cfg, {"tokens": tt})
    logits, aux = tf.forward(model, cfg, {"tokens": tt})
    assert float(loss) == pytest.approx(want_loss, rel=TOL["float32"])
    xent = cross_entropy_loss(logits[:, :-1], tt[:, 1:])
    assert float(loss - xent) == pytest.approx(cfg.moe.router_aux_weight * float(aux), abs=1e-6)
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    want = lm_params_from_reference(want_grads)
    assert set(grads) == set(want)
    assert any(".moe.router" in n for n in grads) and any(".moe.w_down" in n for n in grads)
    assert (arch == ARCTIC) == any(".ffn." in n for n in grads)
    worst = max((_rel(grads[n], want[n]), n) for n in want)
    assert worst[0] <= TOL["float32"], worst


def test_bfloat16_loss_matches_reference(models):
    _, params, _, cfg, model = models(GRANITE, "bfloat16")
    jt, tt = _tokens(3)
    want = _jax_fn("loss_fn", GRANITE, "bfloat16", logits_chunk=8)(params, batch={"tokens": jt})
    got = tf.loss_fn(model, cfg, {"tokens": tt}, logits_chunk=8)
    assert float(got) == pytest.approx(float(want), rel=TOL["bfloat16"])


def test_decode_teacher_forced_matches_reference(models):
    """Prefill 8 tokens, then 4 single steps (capacity min(ceil(T K / E cf),
    T) of the call's T tokens in both packages), bfloat16 to 2e-2."""
    jcfg, params, _, cfg, model = models(GRANITE, "bfloat16")
    jt, tt = _tokens(4, 2, 12)
    jstate = jtf.init_decode_state(jcfg, 2, 16)
    state = tf.init_decode_state(cfg, 2, 16, device="cpu")
    step = _jax_fn("decode_step", GRANITE, "bfloat16")
    for s0, s1 in [(0, 8)] + [(i, i + 1) for i in range(8, 12)]:
        want, jstate = step(params, state=jstate, batch={"tokens": jt[:, s0:s1]})
        got, state = tf.decode_step(model, cfg, state, {"tokens": tt[:, s0:s1]})
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    assert state.pos == int(jstate["pos"]) == 12


def test_train_steps_match_reference(models):
    """Three float32 train steps of granite through the port's
    ``build_train_step``: losses (with the aux), weights and first moments
    against the reference's ``build_train_step``."""
    jcfg, params, np_params, cfg, _ = models(GRANITE, "float32")
    jstep = jax.jit(jax_build_train_step(jcfg, jadamw.AdamWConfig(lr=1e-3), JaxStepConfig()))
    jstate = jadamw.init_state(jadamw.AdamWConfig(lr=1e-3), params)
    model = tf.Transformer(cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(np_params))
    optim_cfg = AdamWConfig(lr=1e-3)
    state = init_state(optim_cfg, dict(model.named_parameters()))
    step = build_train_step(cfg, optim_cfg, StepConfig())
    for i in range(3):
        jt, tt = _tokens(10 + i, 4, 24)
        params, jstate, jm = jstep(params, jstate, {"tokens": jt})
        state, m = step(model, state, {"tokens": tt})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    want = lm_params_from_reference(jax.tree.map(np.asarray, params))
    worst = max((_rel(p, want[n]), n) for n, p in model.named_parameters())
    assert worst[0] <= 1e-5, worst
    want_m = adamw_state_from_reference(jax.tree.map(np.asarray, jstate))["m"]
    worst = max((_rel(state["m"][n], want_m[n]), n) for n in want_m)
    assert worst[0] <= 1e-4, worst


@pytest.mark.parametrize("arch", [GRANITE, ARCTIC])
def test_params_and_adamw_state_cross_both_ways(arch, models):
    """The port's state dict -> the reference's pytree (the tree, shapes and
    dtypes of the reference's ``init_params``) -> the port's -> the
    reference's, leaf for leaf; and an AdamW state the same way."""
    _, params, np_params, cfg, model = models(arch, "float32")
    ref = jax.eval_shape(functools.partial(jtf.init_params, jax_smoke_config(arch)),
                         jax.random.PRNGKey(0))
    assert jax.tree.structure(np_params) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(np_params), jax.tree.leaves(ref)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    back = lm_params_to_reference(cfg, lm_params_from_reference(np_params))
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    jstate = jax.tree.map(np.asarray, jadamw.init_state(jadamw.AdamWConfig(master_fp32=True),
                                                        params))
    jstate["m"] = jax.tree.map(lambda a: a + 1, jstate["m"])
    state = adamw_state_from_reference(jstate)
    assert set(state["m"]) == set(model.state_dict())
    back = adamw_state_to_reference(cfg, state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a, b)
