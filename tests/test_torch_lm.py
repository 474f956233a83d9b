"""The port's decoder LM against the reference, on the CPU.

For the smoke configs of qwen3-0.6b (tied embeddings, qk-norm) and
llama3-8b (untied), the reference's ``init_params`` weights are carried
into the port by ``convert.lm_params_from_reference``, tokens come from a
seeded numpy generator, and both packages run the same calls.  With
``use_flash`` the reference runs its Pallas kernels in interpret mode and
the port its kernels' plain versions (CPU tensors).  Logits and losses
agree to 2e-2, the tolerance of ``tests/test_models_smoke.py``'s
decode-vs-forward check: both packages compute in bfloat16, rounding at
slightly different places.
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

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.launch.serve import BatchedServer as JaxServer
from repro.models import transformer as jtf
from repro.train import StepConfig as JaxStepConfig
from repro.train import build_eval_step as jax_build_eval_step
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch.serve import BatchedServer
from repro_torch.models import transformer as tf
from repro_torch.train import StepConfig, build_eval_step, build_prefill_step

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ["qwen3-0.6b", "llama3-8b"]
TOL = 2e-2


def _pair(arch, **overrides):
    """(reference cfg, reference params, port cfg, port model) with one set of weights."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), **overrides)
    cfg = dataclasses.replace(smoke_config(arch), **overrides)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    model = tf.Transformer(cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(jax.tree.map(np.asarray, params)))
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _pair(arch)
        return cache[arch]

    return get


def _tokens(seed, B, S, vocab):
    t = np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t.astype(np.int64))


def _close(got, want, tol=TOL):
    if isinstance(want, torch.Tensor):
        want = want.detach().float().numpy()
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", JAX_ARCH_IDS)
def test_configs_are_the_reference_configs(arch):
    assert ARCH_IDS == JAX_ARCH_IDS
    for port, ref in [(get_config, jax_get_config), (smoke_config, jax_smoke_config)]:
        assert dataclasses.asdict(port(arch)) == dataclasses.asdict(ref(arch))
    assert get_config(arch).vocab_padded == jax_get_config(arch).vocab_padded


def test_weights_carried_across(models):
    jcfg, params, cfg, model = models("llama3-8b")
    assert len(model.blocks) == cfg.n_layers == 2
    np.testing.assert_array_equal(model.blocks[1].attn.wq.detach().numpy(),
                                  np.asarray(params["blocks"]["pos0"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(model.lm_head.detach().numpy(), np.asarray(params["lm_head"]))


@pytest.mark.parametrize("arch,use_flash", [
    (arch, use_flash) for arch in ARCHS for use_flash in (False, True)
] + [("gemma-7b", False)])  # GeGLU, MHA; at its head_dim 256 below
def test_forward_matches_reference(arch, use_flash, models):
    jcfg, params, cfg, model = models(arch)
    jt, tt = _tokens(1, 2, 24, cfg.vocab_size)
    want, _ = jtf.forward(params, jcfg, {"tokens": jt}, use_flash=use_flash)
    got, _ = tf.forward(model, cfg, {"tokens": tt}, use_flash=use_flash)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("logits_chunk", [0, 8])
def test_loss_matches_reference(arch, use_flash, logits_chunk, models):
    jcfg, params, cfg, model = models(arch)
    jt, tt = _tokens(2, 2, 24, cfg.vocab_size)
    want = jtf.loss_fn(params, jcfg, {"tokens": jt}, use_flash=use_flash,
                       logits_chunk=logits_chunk)
    got = tf.loss_fn(model, cfg, {"tokens": tt}, use_flash=use_flash,
                     logits_chunk=logits_chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_step_matches_reference(arch, models):
    jcfg, params, cfg, model = models(arch)
    jt, tt = _tokens(3, 2, 24, cfg.vocab_size)
    want = jax_build_eval_step(jcfg, JaxStepConfig(use_flash=True, logits_chunk=8))(
        params, {"tokens": jt})
    got = build_eval_step(cfg, StepConfig(use_flash=True, logits_chunk=8))(
        model, {"tokens": tt})
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_flash", [False, True])
def test_decode_teacher_forced_matches_reference(arch, use_flash, models):
    """Prefill 8 tokens, then 4 single steps, the same tokens into both."""
    jcfg, params, cfg, model = models(arch)
    B, S, k = 2, 12, 8
    jt, tt = _tokens(4, B, S, cfg.vocab_size)
    jstate = jtf.init_decode_state(jcfg, B, 16)
    state = tf.init_decode_state(cfg, B, 16, device="cpu")
    want, jstate = jtf.decode_step(params, jcfg, jstate, {"tokens": jt[:, :k]},
                                   use_flash=use_flash)
    got, state = tf.decode_step(model, cfg, state, {"tokens": tt[:, :k]},
                                use_flash=use_flash)
    _close(got, want)
    for i in range(k, S):
        want, jstate = jtf.decode_step(params, jcfg, jstate, {"tokens": jt[:, i:i + 1]},
                                       use_flash=use_flash)
        got, state = tf.decode_step(model, cfg, state, {"tokens": tt[:, i:i + 1]},
                                    use_flash=use_flash)
        _close(got, want)
    assert state.pos == int(jstate["pos"]) == S


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(arch, models):
    jcfg, params, cfg, model = models(arch)
    jt, tt = _tokens(5, 2, 8, cfg.vocab_size)
    want, _ = jtf.prefill(params, jcfg, {"tokens": jt}, 16, use_flash=True)
    got, state = build_prefill_step(cfg, 16, StepConfig(use_flash=True))(
        model, {"tokens": tt})
    assert got.shape == want.shape and state.pos == 8
    _close(got, want)


#: gemma-7b at head_dim 256 is compared in float32: in bfloat16 this
#: 2-layer config amplifies the two packages' rounding to 2.3e-2 on the
#: plain path and 2.4e-2 on the kernel path (one logit of 24576 past 2e-2
#: either way), in float32 both agree to 6e-6.
GEMMA_TOL = 1e-4


@pytest.fixture(scope="module")
def gemma256():
    """gemma-7b's smoke config with its real head_dim, 256, back, computed
    in float32."""
    return _pair("gemma-7b", head_dim=256, compute_dtype="float32")


@pytest.mark.parametrize("use_flash", [False, True])
def test_gemma_head_dim_256_forward_matches_reference(use_flash, gemma256):
    """With ``use_flash`` both packages go through their attention kernels
    (Pallas in interpret mode; the port's plain versions) at head_dim 256."""
    jcfg, params, cfg, model = gemma256
    assert cfg.resolved_head_dim == 256
    jt, tt = _tokens(10, 2, 24, cfg.vocab_size)
    want, _ = jtf.forward(params, jcfg, {"tokens": jt}, use_flash=use_flash)
    got, _ = tf.forward(model, cfg, {"tokens": tt}, use_flash=use_flash)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, GEMMA_TOL)


def test_gemma_head_dim_256_decode_teacher_forced_matches_reference(gemma256):
    """Prefill 8 tokens, then 4 single steps through the kernel path, into a
    float32 128-slot cache (a whole block of the reference's decode kernel)."""
    jcfg, params, cfg, model = gemma256
    B, S, k = 2, 12, 8
    jt, tt = _tokens(11, B, S, cfg.vocab_size)
    jstate = jtf.init_decode_state(jcfg, B, 128, cache_dtype=jnp.float32)
    state = tf.init_decode_state(cfg, B, 128, cache_dtype=torch.float32, device="cpu")
    for s0, s1 in [(0, k)] + [(i, i + 1) for i in range(k, S)]:
        want, jstate = jtf.decode_step(params, jcfg, jstate, {"tokens": jt[:, s0:s1]},
                                       use_flash=True)
        got, state = tf.decode_step(model, cfg, state, {"tokens": tt[:, s0:s1]},
                                    use_flash=True)
        _close(got, want, GEMMA_TOL)
    assert state.pos == int(jstate["pos"]) == S


def test_decode_matches_forward_with_f32_cache(models):
    """The reference's decode-vs-forward check on the port's kernel path."""
    _, _, cfg, model = models("qwen3-0.6b")
    _, tt = _tokens(6, 2, 12, cfg.vocab_size)
    full, _ = tf.forward(model, cfg, {"tokens": tt}, use_flash=True)
    state = tf.init_decode_state(cfg, 2, 12, cache_dtype=torch.float32, device="cpu")
    logits, state = tf.decode_step(model, cfg, state, {"tokens": tt[:, :8]}, use_flash=True)
    _close(logits[:, -1], full[:, 7])
    for i in range(8, 12):
        logits, state = tf.decode_step(model, cfg, state, {"tokens": tt[:, i:i + 1]},
                                       use_flash=True)
        _close(logits[:, 0], full[:, i])


@pytest.mark.parametrize("use_flash,max_len,prompt", [(False, 10, 8), (True, 128, 126)])
def test_cache_write_past_max_len_clamps_like_reference(use_flash, max_len, prompt, models):
    """A prompt, then 4 single tokens, into a cache 2 slots short: the write
    start clamps to max_len - S (``dynamic_update_slice``), ``pos`` runs on
    to max_len + 2 and every slot stays visible.  (With ``use_flash`` the
    cache is 128 long: the reference's kernel pads a shorter cache to its
    128-key block and would see the pad keys once kv_len passes max_len.)"""
    jcfg, params, cfg, model = models("qwen3-0.6b")
    jt, tt = _tokens(7, 2, prompt + 4, cfg.vocab_size)
    jstate = jtf.init_decode_state(jcfg, 2, max_len)
    state = tf.init_decode_state(cfg, 2, max_len, device="cpu")
    for s0, s1 in [(0, prompt)] + [(i, i + 1) for i in range(prompt, prompt + 4)]:
        want, jstate = jtf.decode_step(params, jcfg, jstate, {"tokens": jt[:, s0:s1]},
                                       use_flash=use_flash)
        got, state = tf.decode_step(model, cfg, state, {"tokens": tt[:, s0:s1]},
                                    use_flash=use_flash)
        _close(got, want)
    assert state.pos == int(jstate["pos"]) == max_len + 2
    for i in range(cfg.n_layers):
        for j, name in enumerate("kv"):
            _close(state.layers[i][j], jstate["layers"]["pos0"]["kv"][name][i])


def test_pad_vocab_columns_masked():
    jcfg, params, cfg, model = _pair("llama3-8b", vocab_size=500)
    assert cfg.vocab_padded == 512
    jt, tt = _tokens(8, 2, 6, 500)
    got, _ = tf.forward(model, cfg, {"tokens": tt}, use_flash=True)
    want, _ = jtf.forward(params, jcfg, {"tokens": jt}, use_flash=True)
    assert (got[..., 500:].float() < -1e20).all()
    _close(got[..., :500], want[..., :500])


def test_server_tokens_match_reference_where_decided(models):
    """Greedy tokens equal the reference server's wherever the reference's
    top-2 logit margin exceeds 0.1 (and every earlier token agreed)."""
    jcfg, params, cfg, model = models("qwen3-0.6b")
    jt, tt = _tokens(9, 3, 8, cfg.vocab_size)
    new = 6
    want, _ = JaxServer(jcfg, params, max_len=32).serve(jt, new)
    got, dt = BatchedServer(cfg, model, max_len=32).serve(tt, new)
    assert got.shape == (3, new) and dt > 0
    # the reference's margins along its own tokens
    jstate = jtf.init_decode_state(jcfg, 3, 32)
    logits, jstate = jtf.decode_step(params, jcfg, jstate, {"tokens": jt})
    margins = []
    for t in range(new):
        top2 = np.sort(np.asarray(logits[:, -1], np.float32), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        logits, jstate = jtf.decode_step(params, jcfg, jstate,
                                         {"tokens": want[:, t:t + 1]})
    want, got = np.asarray(want), got.detach().numpy()
    checked = 0
    for b in range(3):
        for t in range(new):
            if margins[t][b] <= 0.1:
                break
            assert got[b, t] == want[b, t], (b, t)
            checked += 1
    assert checked > 0


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b", "arctic-480b",
                                  "internvl2-26b", "hubert-xlarge"])
def test_every_config_is_accepted(arch):
    cfg = get_config(arch)
    tf.check_supported(cfg)
    model = tf.Transformer(smoke_config(arch), device="cpu")
    assert len(model.blocks) == smoke_config(arch).n_layers


def test_serve_module_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
         "--requests", "4"], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "predicted max batch" in res.stdout and "4/4 done" in res.stdout
