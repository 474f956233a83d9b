"""The port's VLM and audio inputs against the reference, on the CPU.

For the smoke configs of internvl2-26b (a VLM: 4 patch embeddings of
width 24 in front of its text) and hubert-xlarge (an encoder over frame
embeddings of width 24, non-causal, vocab 503 padded to 512, no token
embedding), the reference's ``init_params`` weights are carried into the
port by ``convert.lm_params_from_reference`` and inputs are drawn from
numpy seeds, so both packages take the same numbers.  The reference's
calls are ``jax.jit``ted once per shape.

Tolerances are ``tests/test_torch_lm.py``'s: logits and losses agree to
2e-2 in the bfloat16 compute default (both packages round at slightly
different places) and to 1e-4 in float32; gradient leaves are held as in
``tests/test_torch_train.py`` (1e-5 of each leaf's largest value in
float32, 2e-2 in bfloat16).  Prefill then decode is held against the
full forward at 2e-2 with a float32 cache, the rule of
``tests/test_models_smoke.py``.

hubert's bfloat16 logits are the exception, held as
``tests/test_torch_mamba.py`` holds jamba's: their distance from the
reference's (relative norm over the vocabulary) at most 1.5x the
reference's own bfloat16-to-float32 distance.  Its residual stream is
bfloat16 (``in_proj`` projects in the compute dtype), and the reference's
compiled block keeps the residual add that feeds the FFN norm's float32
convert unrounded (XLA's excess precision), so up to 8 of 12288 logits land
1-2 bfloat16 ulps apart (up to 0.039, past 2e-2 + 2e-2 |x|); in float32
the packages agree to 2e-6.  The port does not copy that fusion: done in
the model it made granite-moe-1b-a400m's bfloat16 decode differ from its
forward on the card by 0.039, past the smoke's 0.031.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.configs import smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro.train import StepConfig as JaxStepConfig
from repro.optim import adamw as jadamw
from repro.train import build_prefill_step as jax_build_prefill_step
from repro.train import build_train_step as jax_build_train_step
from repro_torch.configs import SHAPES, concrete_batch, get_config, input_specs, smoke_config
from repro_torch.convert import lm_params_from_reference, lm_params_to_reference
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.train import StepConfig, build_eval_step, build_prefill_step, build_train_step

VLM, AUDIO = "internvl2-26b", "hubert-xlarge"
ARCHS = [VLM, AUDIO]
#: logits and losses: the bfloat16 compute default, and float32
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: gradient leaves, relative to each leaf's largest value
GRAD_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
#: hubert's bfloat16 logits: within this factor of the reference's own
#: bfloat16-to-float32 distance
BF16_NOISE_FACTOR = 1.5


def _cfgs(arch, compute_dtype="bfloat16"):
    over = {"compute_dtype": compute_dtype}
    return (dataclasses.replace(jax_smoke_config(arch), **over),
            dataclasses.replace(smoke_config(arch), **over))


@functools.cache
def _ref_params(arch):
    params = jax.jit(functools.partial(jtf.init_params, jax_smoke_config(arch)))(
        jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _model(arch, compute_dtype="bfloat16"):
    _, cfg = _cfgs(arch, compute_dtype)
    model = tf.Transformer(cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(_ref_params(arch)[1]))
    return cfg, model


def _batch(arch, seed, B=2, S=12, labels=True, n_patches=None):
    """(reference batch, port batch) of the same numbers: a VLM's text of S
    tokens after its patches; an encoder's S frames, with labels (every
    third at -100) when ``labels``."""
    cfg = smoke_config(arch)
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        n = cfg.n_patches if n_patches is None else n_patches
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "patches": rng.standard_normal((B, n, cfg.embed_in_dim), dtype=np.float32)}
    else:
        b = {"embeds": rng.standard_normal((B, S, cfg.embed_in_dim), dtype=np.float32)}
        if labels:
            lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            lab[:, ::3] = -100
            b["labels"] = lab
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _close_logits(arch, compute_dtype, got, want, exact):
    """Logits against the reference's ``want``: elementwise at ``TOL``, or
    for hubert in bfloat16 within ``BF16_NOISE_FACTOR`` of the reference's
    own distance from its float32 logits ``exact()``."""
    if arch != AUDIO or compute_dtype != "bfloat16":
        _close(got, want, TOL[compute_dtype])
        return
    V = smoke_config(arch).vocab_size
    got = got.detach().float().numpy()[..., :V]
    want = np.asarray(want, np.float32)[..., :V]
    exact = np.asarray(exact(), np.float32)[..., :V]
    own = _rel_norm(want, exact)
    assert _rel_norm(got, want) <= BF16_NOISE_FACTOR * own
    assert _rel_norm(got, exact) <= BF16_NOISE_FACTOR * own


@functools.cache
def _jax_forward(arch, compute_dtype, use_flash):
    jcfg, _ = _cfgs(arch, compute_dtype)
    return jax.jit(lambda p, b: jtf.forward(p, jcfg, b, use_flash=use_flash)[0])


@functools.cache
def _jax_loss(arch, compute_dtype, logits_chunk):
    jcfg, _ = _cfgs(arch, compute_dtype)
    return jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(p, jcfg, b, logits_chunk=logits_chunk)))


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32)), tree)


# ------------------------------------------------------------- configs, params

@pytest.mark.parametrize("arch,shape", [(a, s) for a in ARCHS for s in SHAPES
                                        if s != "long_500k"])
def test_input_specs_and_batches_match_reference(arch, shape):
    """Every input's shape and dtype as the reference's ``input_specs``;
    ``concrete_batch`` draws them on the device asked for, labels and
    tokens inside the vocabulary."""
    small_input = dict(n_patches=4 if arch == VLM else 0, embed_in_dim=8)
    cfg = dataclasses.replace(get_config(arch), **small_input)
    jcfg = dataclasses.replace(jax_get_config(arch), **small_input)
    small = dataclasses.replace(SHAPES[shape], seq_len=16, global_batch=2)
    jsmall = dataclasses.replace(JAX_SHAPES[shape], seq_len=16, global_batch=2)
    want = jax_input_specs(jcfg, jsmall)
    specs = input_specs(cfg, small)
    assert {k: (s, str(d).removeprefix("torch.")) for k, (s, d) in specs.items()} == \
        {k: (tuple(s.shape), str(s.dtype)) for k, s in want.items()}
    batch = concrete_batch(cfg, small, seed=3, device="cpu")
    for name, (shp, dtype) in specs.items():
        assert tuple(batch[name].shape) == shp and batch[name].dtype == dtype
        assert batch[name].device.type == "cpu"
        if dtype == torch.int32:
            assert 0 <= int(batch[name].min()) and int(batch[name].max()) < cfg.vocab_size
    again = concrete_batch(cfg, small, seed=3)
    assert all(torch.equal(batch[k], again[k]) for k in batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_follow_the_reference_and_convert_round_trips(arch):
    """The port's parameters are the reference's leaves (``in_proj`` for
    both, no ``embed`` for the encoder, an ``lm_head`` for both), and
    ``convert`` carries them both ways unchanged."""
    cfg = smoke_config(arch)
    tf.check_supported(get_config(arch))
    model = tf.init_params(cfg, seed=1, device="cpu")
    names = {n for n, _ in model.named_parameters() if not n.startswith("blocks.")}
    assert names == ({"embed", "lm_head", "in_proj", "final_norm"} if arch == VLM
                     else {"lm_head", "in_proj", "final_norm"})
    assert tuple(model.in_proj.shape) == (cfg.embed_in_dim, cfg.d_model)
    np_params = _ref_params(arch)[1]
    state = lm_params_from_reference(np_params)
    assert ("embed" in state) == (arch == VLM) and "in_proj" in state
    back = lm_params_to_reference(cfg, state)
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))
    want, got = flat(np_params), flat(back)
    assert set(map(str, got)) == set(map(str, want))
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf)
    mine = lm_params_from_reference(lm_params_to_reference(cfg, model.state_dict()))
    assert all(torch.equal(mine[k], v) for k, v in model.state_dict().items())


# ------------------------------------------------------------------ forward, loss

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("compute_dtype,use_flash", [
    ("bfloat16", False), ("float32", False), ("bfloat16", True)])
def test_forward_matches_reference(arch, compute_dtype, use_flash):
    """Logits of patches + text, or of frames; with ``use_flash`` the
    reference runs its Pallas kernels in interpret mode and the port its
    kernels' plain versions (the encoder's attention non-causal)."""
    cfg, model = _model(arch, compute_dtype)
    jb, tb = _batch(arch, 1, labels=False)
    params = _ref_params(arch)[0]
    want = _jax_forward(arch, compute_dtype, use_flash)(params, jb)
    got, _ = tf.forward(model, cfg, tb, use_flash=use_flash)
    assert got.shape == want.shape == (2, 12 + cfg.n_patches, cfg.vocab_padded)
    assert got.dtype == getattr(torch, compute_dtype)
    _close_logits(arch, compute_dtype, got, want,
                  lambda: _jax_forward(arch, "float32", use_flash)(params, jb))


def test_encoder_attention_is_not_causal():
    """A change to the last frame moves the first frame's logits (the
    model's attention takes ``causal=cfg.causal``), on both routes."""
    cfg, model = _model(AUDIO, "float32")
    _, tb = _batch(AUDIO, 2, labels=False)
    moved = dict(tb, embeds=tb["embeds"].clone())
    moved["embeds"][:, -1] += 1.0
    for use_flash in (False, True):
        a, _ = tf.forward(model, cfg, tb, use_flash=use_flash)
        b, _ = tf.forward(model, cfg, moved, use_flash=use_flash)
        assert (a[:, 0] - b[:, 0]).abs().max() > 1e-3


def test_encoder_pad_columns_masked():
    cfg, model = _model(AUDIO)
    assert (cfg.vocab_size, cfg.vocab_padded) == (503, 512)
    _, tb = _batch(AUDIO, 3, labels=False)
    got, _ = tf.forward(model, cfg, tb, use_flash=True)
    assert (got[..., 503:].float() < -1e20).all()
    assert torch.isfinite(got[..., :503]).all()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("logits_chunk", [0, 5])
def test_loss_matches_reference(arch, logits_chunk):
    """The VLM's loss on text positions only and the encoder's per-frame
    loss with -100 masked, against the reference's ``loss_fn``; chunked
    equal to unchunked (float32 compute, so the two sum the same terms)."""
    for compute_dtype in ("bfloat16", "float32"):
        cfg, model = _model(arch, compute_dtype)
        jb, tb = _batch(arch, 4)
        want, _ = _jax_loss(arch, compute_dtype, logits_chunk)(_ref_params(arch)[0], jb)
        with torch.no_grad():
            got = tf.loss_fn(model, cfg, tb, logits_chunk=logits_chunk)
        assert float(got) == pytest.approx(float(want), rel=TOL[compute_dtype])
    with torch.no_grad():
        whole = tf.loss_fn(model, cfg, tb)
    assert float(got) == pytest.approx(float(whole), rel=1e-6)


# -------------------------------------------------------------- serving steps

def test_vlm_prefill_then_decode_matches_reference_forward():
    """Prefill patches + 8 text tokens, then 4 text tokens one at a time
    with an empty patch prefix, into a float32 cache: each step's logits
    against the reference's full forward at that position (the rule of
    ``tests/test_models_smoke.py``, on the plain path)."""
    cfg, model = _model(VLM)
    B, S, k, P = 2, 12, 8, cfg.n_patches
    jb, tb = _batch(VLM, 6, B=B, S=S)
    full = _jax_forward(VLM, "bfloat16", False)(_ref_params(VLM)[0], jb)
    logits, state = tf.prefill(model, cfg, {"tokens": tb["tokens"][:, :k],
                                            "patches": tb["patches"]},
                               S + P, cache_dtype=torch.float32)
    assert state.pos == P + k
    _close(logits[:, 0], full[:, P + k - 1], TOL["bfloat16"])
    empty = torch.zeros((B, 0, cfg.embed_in_dim))
    for i in range(k, S):
        logits, state = tf.decode_step(model, cfg, state, {
            "tokens": tb["tokens"][:, i:i + 1], "patches": empty})
        _close(logits[:, 0], full[:, P + i], TOL["bfloat16"])
    assert state.pos == P + S


def test_vlm_kernel_decode_matches_reference_kernel_decode():
    """The same prefill and decode steps through the attention kernels
    (the reference's Pallas kernels in interpret mode, the port's plain
    versions) step by step against the reference's, into a 128-slot cache
    (a whole block of the reference's decode kernel)."""
    jcfg, _ = _cfgs(VLM)
    cfg, model = _model(VLM)
    params = _ref_params(VLM)[0]
    B, S, k = 2, 12, 8
    jb, tb = _batch(VLM, 6, B=B, S=S)
    jstate = jtf.init_decode_state(jcfg, B, 128)
    state = tf.init_decode_state(cfg, B, 128, device="cpu")
    jempty = jnp.zeros((B, 0, cfg.embed_in_dim))
    empty = torch.zeros((B, 0, cfg.embed_in_dim))
    for s0, s1 in [(0, k)] + [(i, i + 1) for i in range(k, S)]:
        jp, tp = (jb["patches"], tb["patches"]) if s0 == 0 else (jempty, empty)
        want, jstate = jtf.decode_step(params, jcfg, jstate, {
            "tokens": jb["tokens"][:, s0:s1], "patches": jp}, use_flash=True)
        got, state = tf.decode_step(model, cfg, state, {
            "tokens": tb["tokens"][:, s0:s1], "patches": tp}, use_flash=True)
        _close(got, want, TOL["bfloat16"])
    assert state.pos == int(jstate["pos"]) == S + cfg.n_patches


def test_vlm_prefill_step_matches_reference():
    cfg, model = _model(VLM)
    jb, tb = _batch(VLM, 7, S=8)
    want, _ = jax_build_prefill_step(_cfgs(VLM)[0], 16, JaxStepConfig(use_flash=True))(
        _ref_params(VLM)[0], jb)
    got, state = build_prefill_step(cfg, 16, StepConfig(use_flash=True))(model, tb)
    assert got.shape == want.shape and state.pos == 8 + cfg.n_patches
    _close(got, want, TOL["bfloat16"])


@pytest.mark.parametrize("use_flash", [False, True])
def test_encoder_prefill_step_is_the_forward(use_flash):
    """The encoder's prefill step returns every frame's logits, equal to
    the forward's and to the reference's encode step, recording no graph."""
    cfg, model = _model(AUDIO)
    jb, tb = _batch(AUDIO, 8, labels=False)
    got = build_prefill_step(cfg, 16, StepConfig(use_flash=use_flash))(model, tb)
    assert not got.requires_grad
    full, _ = tf.forward(model, cfg, tb, use_flash=use_flash)
    assert torch.equal(got, full)
    params = _ref_params(AUDIO)[0]
    want = jax.jit(jax_build_prefill_step(_cfgs(AUDIO)[0], 16, JaxStepConfig(
        use_flash=use_flash)))(params, jb)
    _close_logits(AUDIO, "bfloat16", got, want,
                  lambda: _jax_forward(AUDIO, "float32", use_flash)(params, jb))


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_step_matches_loss(arch):
    cfg, model = _model(arch)
    _, tb = _batch(arch, 9)
    got = build_eval_step(cfg, StepConfig(use_flash=True, logits_chunk=5))(model, tb)
    with torch.no_grad():
        want = tf.loss_fn(model, cfg, tb, use_flash=True)
    assert float(got) == pytest.approx(float(want), rel=TOL["bfloat16"])


# ----------------------------------------------------------------- training

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_reference(arch, compute_dtype):
    """The loss and every gradient leaf (``in_proj`` and ``lm_head`` among
    them) against ``jax.value_and_grad`` of the reference's loss."""
    cfg, model = _model(arch, compute_dtype)
    jb, tb = _batch(arch, 10)
    want_loss, want_grads = _jax_loss(arch, compute_dtype, 0)(_ref_params(arch)[0], jb)
    loss = tf.loss_fn(model, cfg, tb)
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    tol = GRAD_TOL[compute_dtype]
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=TOL[compute_dtype])
    want = lm_params_from_reference(_np_tree(want_grads))
    assert set(grads) == set(want)
    for n, g in grads.items():
        w = want[n].float().numpy()
        err = np.abs(g.float().numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, f"{arch} {compute_dtype}: leaf {n} off by {err:.3e}"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_steps_match_reference(arch, microbatch):
    """Two train steps (the first applies lr 0) in float32, ``patches``,
    ``embeds`` and ``labels`` cut along the batch at microbatch 2: losses
    and weights against the reference's ``build_train_step``."""
    jcfg, _ = _cfgs(arch, "float32")
    cfg, model = _model(arch, "float32")
    jb, tb = _batch(arch, 11, B=4)
    jstep = jax.jit(jax_build_train_step(jcfg, jadamw.AdamWConfig(lr=1e-3),
                                         JaxStepConfig(microbatch=microbatch)))
    params = _ref_params(arch)[0]
    jstate = jadamw.init_state(jadamw.AdamWConfig(lr=1e-3), params)
    optim_cfg = AdamWConfig(lr=1e-3)
    state = init_state(optim_cfg, dict(model.named_parameters()))
    step = build_train_step(cfg, optim_cfg, StepConfig(microbatch=microbatch))
    for _ in range(2):
        params, jstate, jm = jstep(params, jstate, jb)
        state, metrics = step(model, state, tb)
        assert float(metrics["loss"]) == pytest.approx(float(jm["loss"]), rel=TOL["float32"])
    want = lm_params_from_reference(_np_tree(params))
    for n, w in model.named_parameters():
        ref = want[n].numpy()
        err = np.abs(w.detach().numpy() - ref).max() / np.abs(ref).max()
        assert err <= GRAD_TOL["float32"], f"{arch}: weight {n} off by {err:.3e}"
