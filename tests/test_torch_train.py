"""The port's training slice against the reference, on the CPU.

For the smoke configs of qwen3-0.6b and rwkv6-3b (2 layers, d_model 64,
vocab 512) the reference's ``init_params`` weights are carried into the
port by ``convert.lm_params_from_reference`` and batches are made with
numpy (or by the reference's ``TokenPipeline``), so both packages take the
same numbers:

* the loss and every gradient leaf against ``jax.value_and_grad`` of the
  reference's ``loss_fn``: 1e-5 relative (of each leaf's largest value)
  computed in float32, the LM tests' 2e-2 in the bfloat16 default;
* three train steps at microbatch 1 and 2 under each remat against the
  reference's ``build_train_step``; remat leaves the float32 result within
  1e-6;
* the int8-compressed data-parallel step on a gloo group of one rank
  against the reference's on a one-device mesh, and at 2 and 4 ranks
  (processes) against a single-process mean of the ranks' compressed
  gradients;
* the trainer (``launch.train.run_training``, ``device="cpu"``): the
  counterparts of ``tests/test_tuner_and_train.py``'s ``TestTrainLoop``,
  and a reference train checkpoint resuming in the port.

The first train step applies lr 0 in both packages (the schedule is read
before the step's increment and is 0 at step 0).
"""

import dataclasses
import datetime
import functools
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import smoke_config as jax_smoke_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import TokenPipeline as JaxTokenPipeline
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.train import StepConfig as JaxStepConfig
from repro.train import build_compressed_dp_train_step as jax_build_compressed_dp_train_step
from repro.train import build_train_step as jax_build_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.convert import (
    adamw_state_from_reference,
    adamw_state_to_reference,
    lm_params_from_reference,
    lm_params_to_reference,
)
from repro_torch.data import DataConfig
from repro_torch.launch.train import TrainLoopConfig, run_training
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, apply_updates, grad_compress, init_state
from repro_torch.train import StepConfig, build_compressed_dp_train_step, build_train_step
from test_torch_shuffle import rank_processes_alone, run_ranks  # noqa: F401  (a fixture)

SRC = Path(__file__).resolve().parents[1] / "src"
#: per-leaf relative tolerance (of the leaf's largest value): float32
#: compute, and the bfloat16 default (the LM tests' tolerance)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ARCHS = ["qwen3-0.6b", "rwkv6-3b"]
LR = 1e-3


def _cfgs(arch, compute_dtype):
    over = {} if compute_dtype == "bfloat16" else {"compute_dtype": compute_dtype}
    return (dataclasses.replace(jax_smoke_config(arch), **over),
            dataclasses.replace(smoke_config(arch), **over))


@pytest.fixture(scope="module")
def ref_params():
    """The reference's weights per arch, numpy and jax."""
    cache = {}

    def get(arch):
        if arch not in cache:
            params = jtf.init_params(jax_smoke_config(arch), jax.random.PRNGKey(0))
            cache[arch] = (params, jax.tree.map(np.asarray, params))
        return cache[arch]

    return get


def _model(cfg, np_params):
    model = tf.Transformer(cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(np_params))
    return model


def _tokens(seed, B, S, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)


def _rel(got: torch.Tensor, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def _assert_tree_close(got: dict, want: dict, tol: float, what: str):
    assert set(got) == set(want), what
    worst = max(((_rel(got[n], want[n]), n) for n in want))
    assert worst[0] <= tol, f"{what}: leaf {worst[1]} off by {worst[0]:.3e} (tolerance {tol})"


def _np_tree(tree):
    """A jax pytree as numpy, bfloat16 as float32 (for comparisons)."""
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32))
                        if jnp.asarray(x).dtype == jnp.bfloat16 else np.asarray(x), tree)


# ------------------------------------------------------------ loss and gradients

@functools.cache
def _jax_value_and_grad(arch, compute_dtype, logits_chunk):
    jcfg, _ = _cfgs(arch, compute_dtype)
    return jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(p, jcfg, b, logits_chunk=logits_chunk)))


def _rel_norm(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


#: RWKV in bfloat16: each package's gradient is 5-13 % (relative norm) from
#: the float32 gradient, so the two differ by about as much; the port is
#: held to stay within this factor of the reference's own distance.
BF16_NOISE_FACTOR = 1.5


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("logits_chunk", [0, 8])
def test_loss_and_gradients_match_reference(arch, compute_dtype, logits_chunk, ref_params):
    """Every leaf of the gradient against ``jax.value_and_grad``; RWKV on
    its training route (the chunked form), as the reference's scan.

    In float32 each leaf agrees to 1e-5 of its largest value.  In bfloat16
    qwen3's agree to 2e-2; RWKV's bfloat16 gradients are dominated by
    bfloat16 rounding in both packages (the reference's own is 5-13 %
    from its float32 gradient), so there each leaf of the port's must be
    as close to the reference's float32 gradient as the reference's
    bfloat16 one, within ``BF16_NOISE_FACTOR`` (relative norm)."""
    _, cfg = _cfgs(arch, compute_dtype)
    params, np_params = ref_params(arch)
    tokens = _tokens(1, 2, 24)
    want_loss, want_grads = _jax_value_and_grad(arch, compute_dtype, logits_chunk)(
        params, {"tokens": jnp.asarray(tokens)})
    model = _model(cfg, np_params)
    loss = tf.loss_fn(model, cfg, {"tokens": torch.from_numpy(tokens)}, wkv_kernel=False,
                      logits_chunk=logits_chunk)
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    tol = TOL[compute_dtype]
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=tol)
    want = lm_params_from_reference(_np_tree(want_grads))
    what = f"{arch} {compute_dtype} gradients"
    if compute_dtype == "float32" or arch != "rwkv6-3b":
        _assert_tree_close(grads, want, tol, what)
        return
    _, exact = _jax_value_and_grad(arch, "float32", logits_chunk)(
        params, {"tokens": jnp.asarray(tokens)})
    exact = lm_params_from_reference(_np_tree(exact))
    for n, g in grads.items():
        ours = _rel_norm(g.float().numpy(), exact[n])
        theirs = _rel_norm(want[n], exact[n])
        assert ours <= BF16_NOISE_FACTOR * theirs, (
            f"{what}: leaf {n} is {ours:.3e} from the float32 gradient, the reference's "
            f"bfloat16 one {theirs:.3e}")


def test_rwkv_kernel_route_gives_the_same_gradients_on_cpu(ref_params):
    """On CPU tensors the kernel route is the kernel's plain version, which
    is differentiable: the routes agree; on the card only the chunked form
    may run under autograd (the kernel wrapper raises)."""
    _, cfg = _cfgs("rwkv6-3b", "float32")
    model = _model(cfg, ref_params("rwkv6-3b")[1])
    batch = {"tokens": torch.from_numpy(_tokens(2, 2, 24))}
    leaves = list(model.parameters())
    g_kernel = torch.autograd.grad(tf.loss_fn(model, cfg, batch), leaves)
    g_plain = torch.autograd.grad(tf.loss_fn(model, cfg, batch, wkv_kernel=False), leaves)
    for a, b in zip(g_kernel, g_plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_serving_calls_record_no_graph(ref_params):
    _, cfg = _cfgs("qwen3-0.6b", "bfloat16")
    model = _model(cfg, ref_params("qwen3-0.6b")[1])
    tokens = torch.from_numpy(_tokens(3, 2, 8))
    state = tf.init_decode_state(cfg, 2, 16, device="cpu")
    logits, _ = tf.decode_step(model, cfg, state, {"tokens": tokens})
    assert not logits.requires_grad
    from repro_torch.train import build_eval_step
    assert not build_eval_step(cfg)(model, {"tokens": tokens}).requires_grad
    assert tf.forward(model, cfg, {"tokens": tokens})[0].requires_grad


# ------------------------------------------------------------------- train step

@functools.cache
def _jax_train_step(arch, compute_dtype, remat, microbatch):
    jcfg, _ = _cfgs(arch, compute_dtype)
    return jax.jit(jax_build_train_step(jcfg, jadamw.AdamWConfig(lr=LR),
                                        JaxStepConfig(remat=remat, microbatch=microbatch)))


def _run_three_steps(arch, compute_dtype, remat, microbatch, np_params):
    _, cfg = _cfgs(arch, compute_dtype)
    model = _model(cfg, np_params)
    optim_cfg = AdamWConfig(lr=LR)
    state = init_state(optim_cfg, dict(model.named_parameters()))
    step = build_train_step(cfg, optim_cfg, StepConfig(remat=remat, microbatch=microbatch))
    losses = []
    for i in range(3):
        state, metrics = step(model, state, {"tokens": torch.from_numpy(_tokens(10 + i, 4, 24))})
        losses.append(float(metrics["loss"]))
    return model, state, losses


TRAIN_CASES = [("qwen3-0.6b", "float32", remat, mb)
               for remat in ("none", "dots", "full") for mb in (1, 2)] + [
    ("qwen3-0.6b", "bfloat16", "none", 1), ("qwen3-0.6b", "bfloat16", "dots", 2),
    ("rwkv6-3b", "float32", "none", 1), ("rwkv6-3b", "float32", "full", 2),
    ("rwkv6-3b", "bfloat16", "none", 2)]


@pytest.mark.parametrize("arch,compute_dtype,remat,microbatch", TRAIN_CASES)
def test_train_steps_match_reference(arch, compute_dtype, remat, microbatch, ref_params):
    """Three steps from the same weights on the same batches: losses,
    weights, AdamW moments and ``step`` against the reference's."""
    params, np_params = ref_params(arch)
    jstep = _jax_train_step(arch, compute_dtype, remat, microbatch)
    jstate = jadamw.init_state(jadamw.AdamWConfig(lr=LR), params)
    want_losses = []
    for i in range(3):
        params, jstate, jm = jstep(params, jstate, {"tokens": jnp.asarray(_tokens(10 + i, 4, 24))})
        want_losses.append(float(jm["loss"]))
    model, state, losses = _run_three_steps(arch, compute_dtype, remat, microbatch, np_params)
    tol = TOL[compute_dtype]
    np.testing.assert_allclose(losses, want_losses, rtol=tol)
    assert int(state["step"]) == int(jstate["step"]) == 3
    what = f"{arch} {compute_dtype} remat={remat} microbatch={microbatch}"
    _assert_tree_close(dict(model.named_parameters()),
                       lm_params_from_reference(_np_tree(params)), tol, what + " weights")
    # The first moments sum three steps' gradients, the later two taken at
    # weights that already differ by the first steps' rounding: 10x the
    # gradients' tolerance.
    # In bfloat16 the moments inherit the gradients' rounding noise (RWKV's
    # is 5-13 %, see BF16_NOISE_FACTOR), so they are held in float32 only.
    if compute_dtype == "float32":
        ref_state = adamw_state_from_reference(_np_tree(jstate))
        _assert_tree_close(state["m"], ref_state["m"], 1e-4, what + " m")


@pytest.mark.parametrize("microbatch", [1, 2])
def test_remat_leaves_float32_result_unchanged(microbatch, ref_params):
    np_params = ref_params("qwen3-0.6b")[1]
    base_model, base_state, base_losses = _run_three_steps(
        "qwen3-0.6b", "float32", "none", microbatch, np_params)
    for remat in ("dots", "full"):
        model, state, losses = _run_three_steps("qwen3-0.6b", "float32", remat, microbatch,
                                                np_params)
        np.testing.assert_allclose(losses, base_losses, rtol=1e-6)
        want = {n: p.detach().numpy() for n, p in base_model.named_parameters()}
        _assert_tree_close(dict(model.named_parameters()), want, 1e-6, f"remat={remat}")
        _assert_tree_close(state["v"], {n: v.numpy() for n, v in base_state["v"].items()},
                           1e-6, f"remat={remat} v")


class _CountOps(TorchDispatchMode):
    """Counts the matrix products that run (a product the selective
    checkpoint serves from its cache never reaches a mode below it)."""

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def test_remat_dots_recomputes_attention_products_only():
    """``dots`` keeps the unbatched products (mm) and recomputes the rest:
    its backward reruns the batched attention products (bmm) but no mm;
    ``full`` reruns both."""
    cfg = smoke_config("qwen3-0.6b")
    model = tf.init_params(cfg, seed=0, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(4, 2, 16))}
    counts = {}
    for remat in ("none", "dots", "full"):
        loss = tf.loss_fn(model, cfg, batch, remat=remat)
        with _CountOps() as ops:
            torch.autograd.grad(loss, list(model.parameters()))
        counts[remat] = ops.counts
    assert counts["dots"]["mm"] == counts["none"]["mm"]
    assert counts["dots"]["bmm"] > counts["none"]["bmm"]
    assert counts["full"]["mm"] > counts["none"]["mm"]
    assert counts["full"]["bmm"] == counts["dots"]["bmm"]


def test_microbatch_must_divide_batch():
    cfg = smoke_config("qwen3-0.6b")
    model = tf.init_params(cfg, seed=0, device="cpu")
    optim_cfg = AdamWConfig()
    step = build_train_step(cfg, optim_cfg, StepConfig(microbatch=3))
    with pytest.raises(ValueError, match="not divisible by microbatch 3"):
        step(model, init_state(optim_cfg, dict(model.named_parameters())),
             {"tokens": torch.from_numpy(_tokens(5, 4, 8))})


def test_train_step_refuses_the_kernels():
    cfg = smoke_config("qwen3-0.6b")
    with pytest.raises(NotImplementedError, match="no gradient"):
        build_train_step(cfg, AdamWConfig(), StepConfig(use_flash=True))
    with pytest.raises(NotImplementedError, match="no gradient"):
        build_compressed_dp_train_step(cfg, AdamWConfig(), None, StepConfig(use_flash=True))


# ------------------------------------------------- compressed data parallelism

@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo process group of one rank in this process (file:// init, so
    parallel test workers cannot collide on a port)."""
    path = tmp_path_factory.mktemp("pg") / "init"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_psum_compressed_w1_matches_reference(world1, ref_params):
    """The same gradients and error state into both: the sum and the new
    residuals bit for bit."""
    rng = np.random.default_rng(6)
    grads = {n: rng.normal(size=p.shape).astype(np.float32) * 1e-2
             for n, p in lm_params_from_reference(ref_params("qwen3-0.6b")[1]).items()}
    errs = {n: rng.normal(size=g.shape).astype(np.float32) * 1e-5 for n, g in grads.items()}
    mesh = jax.make_mesh((1,), ("data",))
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    rep = {n: P() for n in grads}
    fn = shard_map(lambda g, e: jgc.psum_compressed(g, e, "data"), mesh=mesh,
                   in_specs=(rep, rep), out_specs=(rep, rep), check=False)
    want_g, want_e = fn({n: jnp.asarray(g) for n, g in grads.items()},
                        {n: jnp.asarray(e) for n, e in errs.items()})
    got_g, got_e = grad_compress.psum_compressed(
        {n: torch.from_numpy(g) for n, g in grads.items()},
        {n: torch.from_numpy(e) for n, e in errs.items()}, world1)
    for n in grads:
        np.testing.assert_array_equal(got_g[n].numpy(), np.asarray(want_g[n]))
        np.testing.assert_array_equal(got_e[n].numpy(), np.asarray(want_e[n]))


def test_compressed_dp_step_w1_matches_reference(world1, ref_params):
    """Two steps in float32 compute against the reference's step on a
    one-device mesh: loss, gradient norm and weights.  The residuals are
    not compared element by element: quantization is discontinuous, and
    the two packages' float32 gradients (1e-6 apart) move a few int8
    roundings, and so those residuals, by one quantum.
    ``test_psum_compressed_w1_matches_reference`` holds the compression
    itself bit for bit on shared gradients."""
    jcfg, cfg = _cfgs("qwen3-0.6b", "float32")
    params, np_params = ref_params("qwen3-0.6b")
    jopt_cfg = jadamw.AdamWConfig(lr=LR)
    jstate = jadamw.init_state(jopt_cfg, params)
    jerr = jgc.init_error_state(params)
    batch = {"tokens": jnp.asarray(_tokens(20, 4, 24))}
    mesh = jax.make_mesh((1,), ("data",))
    jstep = jax.jit(jax_build_compressed_dp_train_step(jcfg, jopt_cfg, mesh)(
        params, jstate, jerr, batch))
    model = _model(cfg, np_params)
    optim_cfg = AdamWConfig(lr=LR)
    state = init_state(optim_cfg, dict(model.named_parameters()))
    err = grad_compress.init_error_state(dict(model.named_parameters()))
    step = build_compressed_dp_train_step(cfg, optim_cfg, world1)
    lr_sum = 0.0
    for i in range(2):
        batch = _tokens(20 + i, 4, 24)
        params, jstate, jerr, jm = jstep(params, jstate, jerr, {"tokens": jnp.asarray(batch)})
        state, err, m = step(model, state, err, {"tokens": torch.from_numpy(batch)})
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
        lr_sum += float(m["lr"])
    # A moved rounding can turn an element's AdamW update around: at most
    # about lr a step either way.
    want = lm_params_from_reference(_np_tree(params))
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), want[n], rtol=1e-5, atol=3 * lr_sum)
    assert int(state["step"]) == 2


_RANK_SCRIPT = r'''
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, sys.argv[4])
from repro_torch.configs import smoke_config
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, grad_compress, init_state
from repro_torch.train import build_compressed_dp_train_step

rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[5]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
cfg = smoke_config("qwen3-0.6b")
model = tf.init_params(cfg, seed=0, device="cpu")
optim_cfg = AdamWConfig(lr=1e-2)
state = init_state(optim_cfg, dict(model.named_parameters()))
err = grad_compress.init_error_state(dict(model.named_parameters()))
step = build_compressed_dp_train_step(cfg, optim_cfg)
tokens = np.load(sys.argv[6])
b = tokens.shape[1] // world
losses = []
for i in range(tokens.shape[0]):
    shard = torch.from_numpy(tokens[i, rank * b:(rank + 1) * b])
    state, err, m = step(model, state, err, {"tokens": shard})
    losses.append(float(m["loss"]))
torch.save({"params": {n: p.detach() for n, p in model.named_parameters()},
            "err": err, "losses": losses}, f"{out}.{rank}")
dist.barrier()
dist.destroy_process_group()
print(f"rank {rank} done", flush=True)
'''


def _single_process_compressed(tokens, world):
    """The mean of the ranks' int8-compressed gradients, computed in one
    process without collectives: each rank's gradient on its slice, the
    scales' maximum, the int8 payloads summed, divided by the world size."""
    cfg = smoke_config("qwen3-0.6b")
    model = tf.init_params(cfg, seed=0, device="cpu")
    optim_cfg = AdamWConfig(lr=1e-2)
    state = init_state(optim_cfg, dict(model.named_parameters()))
    names, leaves = zip(*model.named_parameters())
    errs = [{n: torch.zeros(p.shape) for n, p in zip(names, leaves)} for _ in range(world)]
    b = tokens.shape[1] // world
    losses = []
    for i in range(tokens.shape[0]):
        g32, loss_sum = [], 0.0
        for r in range(world):
            loss = tf.loss_fn(model, cfg, {"tokens": torch.from_numpy(tokens[i, r * b:(r + 1) * b])},
                              wkv_kernel=False)
            grads = torch.autograd.grad(loss, leaves)
            g32.append({n: g.float() + errs[r][n] for n, g in zip(names, grads)})
            loss_sum += float(loss.detach())
        mean = {}
        for n in names:
            scale = max(grad_compress.quantize(g[n])[1] for g in g32)
            qs = [torch.clamp(torch.round(g[n] / scale), -127, 127).to(torch.int8) for g in g32]
            mean[n] = sum(q.to(torch.int32) for q in qs).float() * scale / world
            for r in range(world):
                errs[r][n] = g32[r][n] - qs[r].float() * scale
        new, state, _ = apply_updates(optim_cfg, {n: p.detach() for n, p in zip(names, leaves)},
                                      mean, state, __import__("repro_torch.optim", fromlist=["x"])
                                      .cosine_schedule(state["step"]))
        with torch.no_grad():
            for n, p in zip(names, leaves):
                p.copy_(new[n])
        losses.append(loss_sum / world)
    return dict(zip(names, leaves)), errs, losses


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_dp_gloo_ranks_match_single_process(world, tmp_path, rank_processes_alone):
    """W gloo ranks, each its own process, three steps on slices of one
    global batch, against ``_single_process_compressed`` (one thread on both
    sides, so the float32 gradients, and so the int8 roundings, agree)."""
    tokens = np.stack([_tokens(30 + i, 8, 16) for i in range(3)])
    np.save(tmp_path / "tokens.npy", tokens)
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    init = f"file://{tmp_path / 'pg'}"
    out = str(tmp_path / "out")
    run_ranks([[sys.executable, str(script), str(r), str(world), init, str(SRC), out,
                str(tmp_path / "tokens.npy")] for r in range(world)],
              {**os.environ, "OMP_NUM_THREADS": "1"})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want_params, want_errs, want_losses = _single_process_compressed(tokens, world)
    finally:
        torch.set_num_threads(threads)
    results = [torch.load(f"{out}.{r}") for r in range(world)]
    for r, got in enumerate(results):
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-6)
        for n, p in want_params.items():
            torch.testing.assert_close(got["params"][n], p.detach(), rtol=1e-6, atol=1e-7)
            torch.testing.assert_close(got["err"][n], want_errs[r][n], rtol=1e-6, atol=1e-9)
        if r:  # the weights stay replicated
            for n in want_params:
                assert torch.equal(got["params"][n], results[0]["params"][n])


# ---------------------------------------------------------------------- trainer

def test_loss_decreases_and_failure_recovery(tmp_path):
    cfg = smoke_config("qwen3-0.6b")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8, structure=0.9)
    out = run_training(cfg, data, TrainLoopConfig(
        steps=100, ckpt_dir=str(tmp_path), ckpt_every=20, log_every=0, fail_at_step=50,
        lr=3e-3), device="cpu")
    assert out["last_step"] == 100
    assert out["losses"][-1] < out["losses"][0] - 0.3
    # failure at step 50 restored from step 40: steps 40-49 ran twice
    assert len(out["losses"]) == 110
    assert len(out["step_seconds"]) == 110


def test_restart_resumes_from_checkpoint(tmp_path):
    cfg = smoke_config("qwen3-0.6b")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    run_training(cfg, data, TrainLoopConfig(steps=10, ckpt_dir=str(tmp_path), ckpt_every=5,
                                            log_every=0), device="cpu")
    out2 = run_training(cfg, data, TrainLoopConfig(steps=12, ckpt_dir=str(tmp_path),
                                                   log_every=0), device="cpu")
    assert out2["last_step"] == 12
    assert len(out2["losses"]) == 2  # only steps 10..12 re-run


def test_deterministic_replay():
    """Same seed + same data cursor -> identical loss trajectory."""
    cfg = smoke_config("qwen3-0.6b")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=7)
    a = run_training(cfg, data, TrainLoopConfig(steps=5, log_every=0), device="cpu")
    b = run_training(cfg, data, TrainLoopConfig(steps=5, log_every=0), device="cpu")
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-6)


def test_restart_after_failure_matches_uninterrupted_run(tmp_path):
    """The replay after a restore is exact: a run with a failure injected
    ends on the same weights as one without."""
    cfg = smoke_config("qwen3-0.6b")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=2)
    clean = run_training(cfg, data, TrainLoopConfig(steps=8, ckpt_dir=str(tmp_path / "a"),
                                                    ckpt_every=3, log_every=0), device="cpu")
    failed = run_training(cfg, data, TrainLoopConfig(steps=8, ckpt_dir=str(tmp_path / "b"),
                                                     ckpt_every=3, log_every=0,
                                                     fail_at_step=5), device="cpu")
    # steps 0-4, the failure at 5 restores step 3, steps 3-7
    assert len(failed["losses"]) == 10
    assert failed["losses"][:5] == clean["losses"][:5]
    assert failed["losses"][5:] == clean["losses"][3:]
    from repro_torch.launch.train import train_state
    model = tf.init_params(cfg, seed=0, device="cpu")
    like = train_state(model, init_state(AdamWConfig(), dict(model.named_parameters())))
    (pa, sa), step_a = CheckpointManager(str(tmp_path / "a")).restore(None, like)
    (pb, sb), step_b = CheckpointManager(str(tmp_path / "b")).restore(None, like)
    assert step_a == step_b == 8
    for n in pa:
        np.testing.assert_array_equal(pa[n], pb[n])
        np.testing.assert_array_equal(sa["v"][n], sb["v"][n])


def test_reference_checkpoint_resumes_in_port(tmp_path, ref_params):
    """A (params, AdamW state) checkpoint written by the reference's
    ``CheckpointManager`` after two train steps restores in the port through
    ``convert``; the port's next step matches the reference's next step.
    Then the port's state crosses back."""
    jcfg, cfg = _cfgs("qwen3-0.6b", "float32")
    params, np_params = ref_params("qwen3-0.6b")
    jopt_cfg = jadamw.AdamWConfig(lr=LR)
    jstate = jadamw.init_state(jopt_cfg, params)
    jstep = _jax_train_step("qwen3-0.6b", "float32", "none", 1)
    pipe = JaxTokenPipeline(JaxDataConfig(vocab_size=512, seq_len=24, global_batch=4, seed=1))
    for i in range(2):
        params, jstate, _ = jstep(params, jstate, pipe.batch_at(i))
    JaxCheckpointManager(str(tmp_path)).save(2, (params, jstate))

    template = tf.Transformer(cfg, device="cpu")
    optim_cfg = AdamWConfig(lr=LR)
    like = (lm_params_to_reference(cfg, template.state_dict()),
            adamw_state_to_reference(cfg, init_state(optim_cfg, dict(template.named_parameters()))))
    (tree_params, tree_state), step = CheckpointManager(str(tmp_path)).restore(None, like)
    assert step == 2
    model = tf.Transformer(cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(tree_params))
    state = adamw_state_from_reference(tree_state)
    assert int(state["step"]) == 2

    batch = np.array(pipe.batch_at(2)["tokens"])
    params, jstate, jm = jstep(params, jstate, {"tokens": jnp.asarray(batch)})
    state, m = build_train_step(cfg, optim_cfg)(model, state, {"tokens": torch.from_numpy(batch)})
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    _assert_tree_close(dict(model.named_parameters()),
                       lm_params_from_reference(_np_tree(params)), 1e-5, "resumed weights")

    back = adamw_state_to_reference(cfg, state)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jstate))
    assert int(back["step"]) == int(jstate["step"]) == 3
    np.testing.assert_allclose(back["m"]["embed"], np.asarray(jstate["m"]["embed"]),
                               rtol=1e-5, atol=1e-5 * float(np.abs(jstate["m"]["embed"]).max()))


def test_bfloat16_train_state_checkpoints_bit_for_bit(tmp_path):
    """bfloat16 weights and states are written as the reference writes
    bfloat16 (``|V2`` items, ``bfloat16`` in the manifest) and restore bit
    for bit into a bfloat16 template."""
    import json
    cfg = dataclasses.replace(smoke_config("qwen3-0.6b"), param_dtype="bfloat16")
    model = tf.init_params(cfg, seed=3, device="cpu")
    optim_cfg = AdamWConfig(state_dtype="bfloat16")
    state = init_state(optim_cfg, dict(model.named_parameters()))
    state, _ = build_train_step(cfg, optim_cfg)(model, state,
                                                {"tokens": torch.from_numpy(_tokens(7, 2, 8))})
    from repro_torch.launch.train import train_state
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, train_state(model, state))
    manifest = json.loads((tmp_path / "step_000000001" / "MANIFEST.json").read_text())
    assert "bfloat16" in {leaf["dtype"] for leaf in manifest["leaves"]}
    (params, restored), _ = mgr.restore(None, train_state(model, state), device="cpu")
    for n, p in model.named_parameters():
        assert params[n].dtype == torch.bfloat16 and torch.equal(params[n], p.detach())
        assert torch.equal(restored["m"][n], state["m"][n])
