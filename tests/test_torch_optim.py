"""The port's optimizer against the reference's, on the CPU.

``optim.adamw`` (``apply_updates``, ``init_state``, ``global_norm``,
``cosine_schedule``) and ``optim.grad_compress`` take the same numbers,
made from a seeded numpy generator, in both packages.  AdamW is held to
1e-6 relative (of each tensor's largest value) with ``step`` equal;
quantization bit for bit (both round half to even).  The last tests are
the counterparts of ``tests/test_substrate.py``'s ``TestAdamW`` and
``TestGradCompression``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro_torch.optim import AdamWConfig, apply_updates, cosine_schedule, global_norm, init_state
from repro_torch.optim import grad_compress as gc

RTOL = 1e-6
SHAPES = {"embed": (64, 16), "blocks.0.attn.wq": (16, 32), "blocks.0.norm1": (16,),
          "final_norm": (16,)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max() or 1))


def _trees(seed, dtype, grad_scale):
    rng = np.random.default_rng(seed)
    params = {n: rng.normal(size=s).astype(np.float32) * 0.1 for n, s in SHAPES.items()}
    grads = {n: rng.normal(size=s).astype(np.float32) * grad_scale for n, s in SHAPES.items()}
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    return ({n: jnp.asarray(p).astype(jdt) for n, p in params.items()},
            {n: jnp.asarray(g).astype(jdt) for n, g in grads.items()},
            {n: torch.from_numpy(p).to(tdt) for n, p in params.items()},
            {n: torch.from_numpy(g).to(tdt) for n, g in grads.items()})


CASES = [  # (param dtype, state dtype, master_fp32, grad_clip)
    ("float32", "float32", False, 1.0),
    ("float32", "float32", False, 0.0),
    ("bfloat16", "float32", False, 1.0),
    ("bfloat16", "bfloat16", False, 1.0),
    ("bfloat16", "bfloat16", False, 0.0),
    ("bfloat16", "float32", True, 1.0),
    ("bfloat16", "bfloat16", True, 0.0),
]


@pytest.mark.parametrize("dtype,state_dtype,master,clip", CASES)
def test_apply_updates_matches_reference(dtype, state_dtype, master, clip):
    """Three steps on the same gradients (large enough that clipping acts),
    the schedule's lr scale as a tensor on the third."""
    kw = dict(lr=1e-2, state_dtype=state_dtype, master_fp32=master, grad_clip=clip)
    jcfg, cfg = jadamw.AdamWConfig(**kw), AdamWConfig(**kw)
    jp, jg, tp, tg = _trees(0, dtype, grad_scale=0.5)
    js, ts = jadamw.init_state(jcfg, jp), init_state(cfg, tp)
    for step in range(3):
        scale = 1.0 if step < 2 else 0.25
        jscale = scale if step < 2 else jnp.float32(scale)
        tscale = scale if step < 2 else torch.tensor(scale)
        jp, js, jm = jadamw.apply_updates(jcfg, jp, jg, js, jscale)
        tp, ts, tm = apply_updates(cfg, tp, tg, ts, tscale)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert ts["step"].dtype == torch.int32
        _close(tm["grad_norm"], jm["grad_norm"])
        _close(tm["lr"], jm["lr"])
        for n in SHAPES:
            assert tp[n].dtype == getattr(torch, dtype)
            assert ts["m"][n].dtype == getattr(torch, state_dtype)
            _close(tp[n], jp[n])
            _close(ts["m"][n], js["m"][n])
            _close(ts["v"][n], js["v"][n])
            if master:
                assert ts["master"][n].dtype == torch.float32
                _close(ts["master"][n], js["master"][n])
    assert set(ts) == set(js)


def test_apply_updates_leaves_inputs_unchanged():
    cfg = AdamWConfig(master_fp32=True)
    _, _, tp, tg = _trees(1, "float32", 1.0)
    state = init_state(cfg, tp)
    before = ({n: p.clone() for n, p in tp.items()},
              {n: m.clone() for n, m in state["master"].items()})
    apply_updates(cfg, tp, tg, state)
    assert all(torch.equal(tp[n], before[0][n]) for n in tp)
    assert all(torch.equal(state["master"][n], before[1][n]) for n in tp)
    assert int(state["step"]) == 0


def test_global_norm_matches_reference():
    jp, _, tp, _ = _trees(2, "bfloat16", 1.0)
    _close(global_norm(tp), jadamw.global_norm(jp))


@pytest.mark.parametrize("step", [0, 1, 50, 100, 5000, 10000])
def test_cosine_schedule_matches_reference(step):
    want = float(jadamw.cosine_schedule(jnp.int32(step)))
    got = float(cosine_schedule(torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=RTOL, abs=RTOL)
    if step == 0:
        assert got == want == 0.0  # the first train step applies lr 0


# ------------------------------------------------------- gradient compression

def _grads(seed, n=1000, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n,)) * scale).astype(np.float32)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 1e4)])
def test_quantize_bit_for_bit(seed, scale):
    g = _grads(seed, scale=scale)
    jq, js = jgc.quantize(jnp.asarray(g))
    tq, ts = gc.quantize(torch.from_numpy(g))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    np.testing.assert_array_equal(gc.dequantize(tq, ts).numpy(), np.asarray(jgc.dequantize(jq, js)))


def test_quantize_rounds_half_to_even_as_reference():
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 0.0], np.float32)
    tq, ts = gc.quantize(torch.from_numpy(g))
    jq, _ = jgc.quantize(jnp.asarray(g))
    assert float(ts) == 1.0
    np.testing.assert_array_equal(tq.numpy(), [127, 0, 2, 2, 0, -2, 4, 0])
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_zero_gradient_scale_floor():
    tq, ts = gc.quantize(torch.zeros(8))
    jq, js = jgc.quantize(jnp.zeros(8))
    assert float(ts) == float(js) == pytest.approx(1e-12)
    assert not tq.any()


def test_compress_tree_matches_reference():
    g = {"a": _grads(3), "b": _grads(4, n=50, scale=1e-2)}
    e = {"a": _grads(5, scale=1e-3), "b": _grads(6, n=50, scale=1e-5)}
    jq, je = jgc.compress_tree({k: jnp.asarray(v) for k, v in g.items()},
                               {k: jnp.asarray(v) for k, v in e.items()})
    tq, te = gc.compress_tree({k: torch.from_numpy(v) for k, v in g.items()},
                              {k: torch.from_numpy(v) for k, v in e.items()})
    for k in g:
        np.testing.assert_array_equal(tq[k][0].numpy(), np.asarray(jq[k][0]))
        assert float(tq[k][1]) == float(jq[k][1])
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]))
    jd, td = jgc.decompress_tree(jq), gc.decompress_tree(tq)
    for k in g:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))


def test_error_feedback_over_50_steps_matches_reference():
    """TestGradCompression's error-feedback run, step by step in both
    packages: the same residuals and the same cumulative applied gradient,
    which tracks the true one within 2 %."""
    rng = np.random.default_rng(0)
    g_true = (rng.normal(size=(64,)) * 1e-3).astype(np.float32)
    jg, tg = jnp.asarray(g_true), torch.from_numpy(g_true)
    jerr = jgc.init_error_state({"g": jg})["g"]
    terr = gc.init_error_state({"g": tg})["g"]
    japplied, tapplied = jnp.zeros_like(jg), torch.zeros_like(tg)
    for _ in range(50):
        jq, js = jgc.quantize(jg + jerr)
        tq, ts = gc.quantize(tg + terr)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        jdeq, tdeq = jgc.dequantize(jq, js), gc.dequantize(tq, ts)
        jerr, terr = (jg + jerr) - jdeq, (tg + terr) - tdeq
        japplied, tapplied = japplied + jdeq, tapplied + tdeq
        np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
    np.testing.assert_allclose(tapplied.numpy(), g_true * 50, rtol=0.02)
    np.testing.assert_array_equal(tapplied.numpy(), np.asarray(japplied))


def test_quantize_roundtrip_bound():
    g = torch.from_numpy(_grads(1).astype(np.float64))
    q, scale = gc.quantize(g)
    err = (gc.dequantize(q, scale) - g.float()).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-9


# ------------------------------------------ TestAdamW's counterparts

def test_converges_on_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_state(cfg, params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(200):
        params, state, _ = apply_updates(cfg, params, {"w": params["w"] - target}, state)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


def test_grad_clip_reports_pre_clip_norm():
    cfg = AdamWConfig(lr=0.0, grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    _, _, metrics = apply_updates(cfg, params, {"w": torch.full((3,), 100.0)},
                                  init_state(cfg, params))
    assert float(metrics["grad_norm"]) > 100.0


def test_bf16_states_halve_memory():
    params = {"w": torch.zeros((128, 128))}
    s32 = init_state(AdamWConfig(state_dtype="float32"), params)
    s16 = init_state(AdamWConfig(state_dtype="bfloat16"), params)
    assert s16["m"]["w"].dtype == torch.bfloat16
    assert s32["m"]["w"].nbytes == 2 * s16["m"]["w"].nbytes


def test_master_fp32_tracks():
    cfg = AdamWConfig(lr=0.01, master_fp32=True, weight_decay=0.0)
    params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    state = init_state(cfg, params)
    grads = {"w": torch.full((4,), 1e-3, dtype=torch.bfloat16)}
    for _ in range(3):
        params, state, _ = apply_updates(cfg, params, grads, state)
    assert state["master"]["w"].dtype == torch.float32
    assert params["w"].dtype == torch.bfloat16
