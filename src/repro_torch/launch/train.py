"""Training loop with checkpoint/restart and failure retry; counterpart of
``repro.launch.train``.

Usable as a module (``run_training``) or as a command::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 50 --batch 8 --seq 512 --ckpt-dir build/train_ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
        --steps 10 --batch 8 --seq 512

An MoE config trains through the same step: its loss, the reported
``loss`` metric included, carries ``router_aux_weight`` times the layers'
summed Switch aux.  Mamba configs train too (jamba-v0.1-52b at its smoke
config: its optimizer state fits no card).

Fault tolerance:

* every ``ckpt_every`` steps the whole train state (weights and AdamW
  state) is saved asynchronously (copied to host memory at once, written
  on a background thread, one save in flight) with an atomic publish;
* a step that fails (injected with ``fail_at_step`` or real) triggers a
  restore from the latest checkpoint and a replay; the data pipeline is
  stateless per step, so the replay is exact;
* a new run in the same ``ckpt_dir`` (a new process, possibly on another
  mesh) resumes from ``LATEST``; a restore, after a failure too, lays each
  leaf out on the current mesh.

On a mesh the weights and the AdamW state are DTensors laid out by
``sharding.rules.param_specs`` (``_make_sharded_step``) and each batch is
split over the dp axes.  Without one the default is a ``(1, world)``
``("data", "model")`` mesh over an initialised process group of more than
one rank, as in the reference; a process with no group, or a group of one
rank, runs unsharded (a caller that wants a one-rank mesh passes it).
The per-step wall times (fenced by ``torch.cuda.synchronize`` on the card)
are the profiling phase of the paper: ``repro_torch.train_lm`` fits them
against the microbatch knob.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ModelConfig, get_config, smoke_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.sharding import layout, rules
from repro_torch.sharding.context import use_mesh
from repro_torch.train import step as step_mod


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str | None = None
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    lr: float = 3e-4
    fail_at_step: int | None = None   # failure injection (tests/demos)
    max_retries: int = 2


def train_state(model, opt_state: dict) -> tuple:
    """(weights by name, AdamW state): what a train checkpoint holds."""
    return ({n: p.detach() for n, p in model.named_parameters()}, opt_state)


def _make_sharded_step(cfg, optim_cfg, step_cfg, mesh):
    """(step, parameter specs, AdamW state specs) on ``mesh``: the dp axes
    are every axis but ``model``; the state mirrors the parameters.  The
    step splits each batch over the dp axes and runs under the mesh."""
    axes = rules.mesh_axes(mesh)
    mesh_shape = rules.mesh_shape_of(mesh)
    params_like = dict(tf.Transformer(cfg, device="meta").named_parameters())
    pspec = rules.param_specs(params_like, axes, mesh_shape=mesh_shape)
    ospec = rules.opt_specs({"master": None} if optim_cfg.master_fp32 else {}, pspec)
    fn = step_mod.build_train_step(cfg, optim_cfg, step_cfg)

    def step(model, opt_state, batch):
        with use_mesh(mesh):
            bspec = rules.batch_specs(batch, axes, mesh_shape)
            batch = {k: layout.distribute(v, mesh, bspec[k]) for k, v in batch.items()}
            return fn(model, opt_state, batch)

    return step, pspec, ospec


def _fresh(cfg, optim_cfg, loop, dev, mesh=None, pspec=None):
    model = tf.init_params(cfg, seed=loop.seed, device=dev)
    if mesh is not None:
        layout.shard_module(model, mesh, pspec)
    with use_mesh(mesh):
        return model, adamw.init_state(optim_cfg, dict(model.named_parameters()))


def _restore(mgr, model, opt_state, dev, mesh=None, specs=None):
    """The latest checkpoint's weights written into ``model`` (on a mesh,
    each leaf re-sharded onto it, whatever mesh saved it); returns (its
    AdamW state, its step)."""
    (params, opt_state), step = mgr.restore(None, train_state(model, opt_state), device=dev,
                                            mesh=mesh, placements=specs)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if mesh is None:
                p.copy_(params[n])
            else:
                p.to_local().copy_(params[n].to_local())
    return opt_state, step


def run_training(
    cfg: ModelConfig,
    data_cfg: DataConfig,
    loop: TrainLoopConfig = TrainLoopConfig(),
    step_cfg: step_mod.StepConfig = step_mod.StepConfig(),
    optim_cfg: adamw.AdamWConfig | None = None,
    device="cuda",
    mesh=None,
) -> dict:
    """Returns {"losses": [...], "step_seconds": [...], "last_step": int}."""
    dev = resolve_device(device)
    optim_cfg = optim_cfg or adamw.AdamWConfig(lr=loop.lr)
    if mesh is None and dist.is_initialized() and dist.get_world_size() > 1:
        mesh = make_mesh((1, dist.get_world_size()), ("data", "model"))
    specs = pspec = None
    if mesh is None:
        train_step = step_mod.build_train_step(cfg, optim_cfg, step_cfg)
    else:
        train_step, pspec, ospec = _make_sharded_step(cfg, optim_cfg, step_cfg, mesh)
        specs = (pspec, ospec)
    pipeline = TokenPipeline(data_cfg, device=dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)

    mgr = CheckpointManager(loop.ckpt_dir, keep=loop.keep) if loop.ckpt_dir else None
    model, opt_state = _fresh(cfg, optim_cfg, loop, dev, mesh, pspec)
    start_step = 0
    if mgr is not None and mgr.latest_step() is not None:
        # elastic resume: the restore re-shards onto the *current* mesh
        opt_state, start_step = _restore(mgr, model, opt_state, dev, mesh, specs)
        print(f"[train] resumed from checkpoint at step {start_step}")

    losses: list[float] = []
    times: list[float] = []
    injected_failures = {loop.fail_at_step} if loop.fail_at_step else set()
    step = start_step
    retries = 0
    while step < loop.steps:
        batch = pipeline.batch_at(step)
        t0 = time.perf_counter()
        try:
            if step in injected_failures:
                injected_failures.discard(step)
                raise RuntimeError("injected node failure")
            opt_state, metrics = train_step(model, opt_state, batch)
            sync()
        except Exception as e:  # noqa: BLE001 — failure-retry boundary
            retries += 1
            if mgr is None or retries > loop.max_retries:
                raise
            print(f"[train] step {step} failed ({e}); restoring from latest checkpoint")
            mgr.wait()
            del model, opt_state
            model, opt_state = _fresh(cfg, optim_cfg, loop, dev, mesh, pspec)
            if mgr.latest_step() is not None:
                opt_state, step = _restore(mgr, model, opt_state, dev, mesh, specs)
            else:
                step = 0
            continue
        dt = time.perf_counter() - t0
        metrics = {k: layout.full(v) for k, v in metrics.items()}
        losses.append(float(metrics["loss"]))
        times.append(dt)
        step += 1
        if loop.log_every and step % loop.log_every == 0:
            print(f"[train] step {step}/{loop.steps} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} {dt * 1e3:.0f}ms/step")
        if mgr is not None and step % loop.ckpt_every == 0:
            mgr.save_async(step, train_state(model, opt_state))
    if mgr is not None:
        mgr.wait()
        mgr.save(step, train_state(model, opt_state))
    return {"losses": losses, "step_seconds": times, "last_step": step}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config for the arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    out = run_training(
        cfg, data_cfg,
        TrainLoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                        ckpt_every=args.ckpt_every, lr=args.lr, fail_at_step=args.fail_at),
        device=args.device,
    )
    print(f"final loss {out['losses'][-1]:.4f} (first {out['losses'][0]:.4f}); "
          f"median step {np.median(out['step_seconds']) * 1e3:.0f}ms")


if __name__ == "__main__":
    main()
