"""The port's sharded LM on four gloo ranks against the single-process port.

One world of 4 gloo rank processes (``file://`` init under ``tmp_path``,
60 s collective timeout, 240 s for the parent), holding the session's
rank-process lock of ``tests/test_torch_shuffle.py``.  On a (2, 2)
("data", "model") mesh, in float32, for the llama3-8b, granite-moe-1b-a400m,
rwkv6-3b and jamba-v0.1-52b smoke configs, each rank measures against the
same computation without a mesh (each rank holds the whole model too):

* forward logits, and a prefill plus one decode step, within 2e-5
  relative (norm of the difference over the norm), on the (2, 2) mesh,
  and for llama3-8b and jamba on a (1, 4) one too (kv heads that do not
  divide the model axis, a cache sharded by sequence);
* every gradient leaf of the loss within 1e-5 relative on the (2, 2) mesh
  (and on (1, 4) where that runs), a leaf whose gradient is zero exactly
  zero: a partial sum reduced twice or not at all on a small replicated
  leaf (a router, RWKV's ``u``, a norm) shows here, where AdamW's update
  would hide it;
* three train steps with ``fsdp=True`` specs (the first applies lr 0):
  losses within 1e-5 relative, ``grad_norm`` within 1e-5 (rwkv6-3b 5e-5,
  see ``GRAD_NORM``), and each weight leaf within 1e-5 relative, but a
  leaf initialised at zero (Mamba's conv bias), which holds only Adam's
  updates, within 1e-5 times the learning rate absolutely;
* the trained state saved from a (1, 4) mesh restores onto the (2, 2)
  mesh and onto plain tensors bit for bit;
* the mesh form of the compressed DP step (a (4, 1) mesh's ``data``
  axis) is bit-equal to the ``group=`` form over the same four ranks.

A second world of two ranks runs ``run_training`` with a failure and its
restore (``test_sharded_trainer_restores_one_step_on_every_rank``).
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path


from test_torch_shuffle import rank_processes_alone, run_ranks  # noqa: F401  (a fixture)

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("llama3-8b", "granite-moe-1b-a400m", "rwkv6-3b", "jamba-v0.1-52b")
#: also run on a (1, 4) mesh: a dense and a hybrid model whose 2 kv heads do
#: not divide the 4-way model axis
ON_1X4 = ("llama3-8b", "jamba-v0.1-52b")

#: the train steps' learning rate, and the absolute limit on a leaf that
#: starts at zero after them
LR = 1e-2
ZERO_INIT_ABS = 1e-5 * LR
#: the relative limit on each train step's grad_norm.  rwkv6-3b's third
#: batch is ill-conditioned in the chunked WKV form: on it the
#: single-process float32 gradients are 2.9e-4 from a float64 run's, their
#: norm 1.8e-4 from float64's norm, the sharded norm 1.5e-4, and the two
#: float32 norms 2.7e-5 from each other; so rwkv6-3b is held to 5e-5.
GRAD_NORM = {"rwkv6-3b": 5e-5}

_RANK_SCRIPT = r"""
import dataclasses, datetime, json, sys
rank, world, init, src, out, ckpt = sys.argv[1:7]
rank, world = int(rank), int(world)
sys.path.insert(0, src)
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import train_state
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, grad_compress, init_state
from repro_torch.sharding import context, layout, rules
from repro_torch.train import StepConfig, build_compressed_dp_train_step, build_train_step

mesh22 = make_mesh((2, 2), ("data", "model"))
mesh14 = make_mesh((1, 4), ("data", "model"))
mesh41 = make_mesh((4, 1), ("data", "model"))
full = layout.full


def rel(a, b):
    a, b = full(a).detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


def specs(model, mesh):
    return rules.param_specs(dict(model.named_parameters()), rules.mesh_axes(mesh), fsdp=True,
                             fsdp_min_size=8, mesh_shape=rules.mesh_shape_of(mesh))


def put(t, mesh):
    spec = rules.batch_specs({"t": t}, rules.mesh_axes(mesh), rules.mesh_shape_of(mesh))["t"]
    return layout.distribute(t, mesh, spec)


def grads(m, mesh, tok):
    with context.use_mesh(mesh):
        loss = tf.loss_fn(m, cfg, {"tokens": tok if mesh is None else put(tok, mesh)})
        return dict(zip([n for n, _ in m.named_parameters()],
                        torch.autograd.grad(loss, list(m.parameters()))))


def leafwise(got, want):
    # {leaf: relative difference}, and for the leaves that want holds at
    # zero {leaf: the largest absolute value of got's}
    rels, zeros = {}, {}
    for n, b in want.items():
        a = full(got[n]).detach().float()
        if float(b.norm()) > 0:
            rels[n] = rel(a, b)
        else:
            zeros[n] = float(a.abs().max())
    return rels, zeros


ON_1X4 = ("llama3-8b", "jamba-v0.1-52b")
LR = 1e-2
res = {}
for arch in sys.argv[7:]:
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32")
    r = res[arch] = {}
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32))
    ref = tf.init_params(cfg, seed=0, device="cpu")
    model = tf.init_params(cfg, seed=0, device="cpu")
    layout.shard_module(model, mesh22, specs(model, mesh22))
    with torch.no_grad():
        want, _ = tf.forward(ref, cfg, {"tokens": tok})
        p_want, st = tf.prefill(ref, cfg, {"tokens": tok[:, :24]}, 32, cache_dtype=torch.float32)
        d_want, _ = tf.decode_step(ref, cfg, st, {"tokens": tok[:, 24:25]})
        with context.use_mesh(mesh22):
            got, _ = tf.forward(model, cfg, {"tokens": put(tok, mesh22)})
            p_got, st = tf.prefill(model, cfg, {"tokens": put(tok[:, :24], mesh22)}, 32,
                                   cache_dtype=torch.float32)
            d_got, _ = tf.decode_step(model, cfg, st, {"tokens": put(tok[:, 24:25], mesh22)})
            r["forward"] = rel(got, want)
            r["prefill"] = rel(p_got, p_want)
            r["decode"] = rel(d_got, d_want)
    # every gradient leaf on (2, 2), before any step
    g_want = grads(ref, None, tok)
    r["grads_22"] = leafwise(grads(model, mesh22, tok), g_want)
    if arch in ON_1X4:
        # (1, 4): kv heads 2 do not divide a 4-way model axis, so K/V are
        # replicated (each rank slicing its query heads' kv head) and the
        # cache is sharded by sequence
        m14 = tf.init_params(cfg, seed=0, device="cpu")
        layout.shard_module(m14, mesh14, specs(m14, mesh14))
        with torch.no_grad(), context.use_mesh(mesh14):
            got, _ = tf.forward(m14, cfg, {"tokens": put(tok, mesh14)})
            p_got, st = tf.prefill(m14, cfg, {"tokens": put(tok[:, :24], mesh14)}, 32,
                                   cache_dtype=torch.float32)
            d_got, _ = tf.decode_step(m14, cfg, st, {"tokens": put(tok[:, 24:25], mesh14)})
            r["forward_14"] = max(rel(got, want), rel(p_got, p_want), rel(d_got, d_want))
        r["grads_14"] = leafwise(grads(m14, mesh14, tok), g_want)

    # three train steps; the first applies lr 0
    ocfg = AdamWConfig(lr=LR)
    step = build_train_step(cfg, ocfg, StepConfig())
    o_ref = init_state(ocfg, dict(ref.named_parameters()))
    with context.use_mesh(mesh22):
        o_got = init_state(ocfg, dict(model.named_parameters()))
    losses, norms = [], []
    for i in range(3):
        batch = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32))
        o_ref, m_ref = step(ref, o_ref, {"tokens": batch})
        with context.use_mesh(mesh22):
            o_got, m_got = step(model, o_got, {"tokens": put(batch, mesh22)})
        for acc, key in ((losses, "loss"), (norms, "grad_norm")):
            acc.append(abs(float(full(m_got[key])) - float(m_ref[key])) / abs(float(m_ref[key])))
    r["losses"], r["grad_norm"] = max(losses), max(norms)
    # each weight leaf on its own; those initialised at zero (biases, Mamba's
    # conv bias) hold only Adam's updates, so they are held absolutely
    init = dict(tf.init_params(cfg, seed=0, device="cpu").named_parameters())
    got_w = dict(model.named_parameters())
    r["weights"], r["weights_zero_init"] = {}, {}
    for n, a in ref.named_parameters():
        d = full(got_w[n]).detach().float() - a.detach().float()
        if bool((init[n] == 0).all()):
            r["weights_zero_init"][n] = float(d.abs().max())
        else:
            r["weights"][n] = float(d.norm() / a.detach().float().norm())

    # the trained state saved from (1, 4), restored onto (2, 2) and plain
    plain = train_state(ref, o_ref)
    s14, s22 = specs(ref, mesh14), specs(ref, mesh22)
    o22 = {"step": None, "m": s22, "v": s22}
    on14 = ({n: layout.distribute(t, mesh14, s14[n]) for n, t in plain[0].items()},
            {"step": plain[1]["step"], "m": {n: layout.distribute(t, mesh14, s14[n])
                                             for n, t in plain[1]["m"].items()},
             "v": {n: layout.distribute(t, mesh14, s14[n]) for n, t in plain[1]["v"].items()}})
    mgr = CheckpointManager(f"{ckpt}/{arch}")
    dist.barrier()
    mgr.save(3, on14)
    back22, _ = CheckpointManager(f"{ckpt}/{arch}").restore(None, plain, device="cpu",
                                                            mesh=mesh22, placements=(s22, o22))
    back, _ = CheckpointManager(f"{ckpt}/{arch}").restore(None, plain, device="cpu")
    leaves = [(plain[0], back22[0], back[0])] + [
        (plain[1][k], back22[1][k], back[1][k]) for k in ("m", "v")]
    r["ckpt_22"] = all(torch.equal(full(b[n]), a[n]) and b[n].placements ==
                       tuple(rules.placements(s22[n], mesh22)) for a, b, _ in leaves for n in a)
    r["ckpt_plain"] = all(torch.equal(c[n], a[n]) for a, _, c in leaves for n in a) and \
        torch.equal(back[1]["step"], plain[1]["step"])

    # the compressed DP step: mesh form against group= form, two steps
    outs = []
    for kw in ({"group": None}, {"mesh": mesh41, "axis": "data"}):
        m = tf.init_params(cfg, seed=0, device="cpu")
        params = dict(m.named_parameters())
        fn = build_compressed_dp_train_step(cfg, ocfg, **kw)
        opt, err = init_state(ocfg, params), grad_compress.init_error_state(params)
        for i in range(2):
            opt, err, met = fn(m, opt, err, {"tokens": tok[rank:rank + 1]})
        outs.append(([p.detach().clone() for p in m.parameters()], float(met["loss"])))
    r["compressed"] = outs[0][1] == outs[1][1] and all(
        torch.equal(a, b) for a, b in zip(outs[0][0], outs[1][0]))
dist.barrier()
dist.destroy_process_group()
with open(f"{out}.{rank}", "w") as f:
    json.dump(res, f)
"""


_TRAINER_SCRIPT = r"""
import dataclasses, datetime, json, sys
rank, world, init, src, out, ckpt = sys.argv[1:7]
rank, world = int(rank), int(world)
sys.path.insert(0, src)
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs import smoke_config
from repro_torch.data import DataConfig
from repro_torch.launch.train import TrainLoopConfig, run_training

cfg = dataclasses.replace(smoke_config("qwen3-0.6b"), compute_dtype="float32")
data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=0)
loop = TrainLoopConfig(steps=6, ckpt_every=3, fail_at_step=3, log_every=0, lr=1e-2)
# the unsharded trainer (no process group yet), the same failure replayed
plain = run_training(cfg, data, dataclasses.replace(loop, ckpt_dir=f"{ckpt}/plain{rank}"),
                     device="cpu")
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
# the default mesh, (1, world), and one checkpoint directory for all ranks
got = run_training(cfg, data, dataclasses.replace(loop, ckpt_dir=f"{ckpt}/sharded"),
                   device="cpu")
dist.barrier()
dist.destroy_process_group()
with open(f"{out}.{rank}", "w") as f:
    json.dump({"plain": plain, "sharded": got}, f)
"""


def test_sharded_trainer_restores_one_step_on_every_rank(tmp_path, rank_processes_alone):
    """``run_training`` on two gloo ranks (its default (1, 2) mesh), failing
    at step 3 just as the step-3 checkpoint is being written: every rank
    restores that step (the ranks meet once rank 0 has committed it), so
    both record the same losses, and these are the unsharded trainer's
    replay within 1e-5 relative."""
    script = tmp_path / "trainer.py"
    script.write_text(_TRAINER_SCRIPT)
    init = f"file://{tmp_path / 'pg'}"
    out = str(tmp_path / "out")
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    run_ranks([[sys.executable, str(script), str(r), "2", init, str(SRC), out, str(ckpt)]
               for r in range(2)], {**os.environ, "OMP_NUM_THREADS": "1"})
    res = [json.loads(Path(f"{out}.{rank}").read_text()) for rank in range(2)]
    assert res[0]["sharded"]["losses"] == res[1]["sharded"]["losses"], res
    for r in res:
        got, want = r["sharded"], r["plain"]
        assert got["last_step"] == want["last_step"] == 6, r
        assert len(got["losses"]) == len(want["losses"]) == 6, r
        assert max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])) <= 1e-5, r


def test_sharded_ranks_match_single_process(tmp_path, rank_processes_alone):
    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    init = f"file://{tmp_path / 'pg'}"
    out = str(tmp_path / "out")
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    run_ranks([[sys.executable, str(script), str(r), "4", init, str(SRC), out, str(ckpt),
                *ARCHS] for r in range(4)],
              {**os.environ, "OMP_NUM_THREADS": "1"})
    for rank in range(4):
        res = json.loads(Path(f"{out}.{rank}").read_text())
        assert sorted(res) == sorted(ARCHS)
        for arch, r in res.items():
            ctx = (rank, arch, r)
            assert r["forward"] <= 2e-5, ctx
            assert r["prefill"] <= 2e-5, ctx
            assert r["decode"] <= 2e-5, ctx
            grads = ("grads_22", "grads_14") if arch in ON_1X4 else ("grads_22",)
            if arch in ON_1X4:
                assert r["forward_14"] <= 2e-5, ctx
            for key in grads:
                rels, zeros = r[key]
                assert max(rels.values()) <= 1e-5, (key, ctx)
                assert max(zeros.values(), default=0.0) == 0.0, (key, ctx)
            assert r["losses"] <= 1e-5, ctx
            assert r["grad_norm"] <= GRAD_NORM.get(arch, 1e-5), ctx
            assert max(r["weights"].values()) <= 1e-5, ctx
            assert max(r["weights_zero_init"].values(), default=0.0) <= ZERO_INIT_ABS, ctx
            assert r["ckpt_22"] and r["ckpt_plain"], ctx
            assert r["compressed"], ctx
