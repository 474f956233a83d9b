"""AdamW with a configurable state dtype and gradient clipping
(counterpart of ``repro.optim.adamw``).

Plain functions over dicts of tensors (name -> tensor, in the order of
``model.named_parameters()``), with the reference's arithmetic and dtypes:
the gradient norm in float32 and clipping by ``min(1, clip / (norm +
1e-9))``; ``m`` and ``v`` stored in ``state_dtype`` (bfloat16 halves them);
the update computed in float32 and cast to the parameter dtype; weight
decay on every parameter, norms included; an optional float32 master copy
(``master_fp32``).  ``step`` is an int32 tensor on the parameters' device,
so a step never reads the host.  Each elementwise op runs once over all
tensors (``torch._foreach_*``), not once per tensor.  ``torch.optim.AdamW``
is not used: its state dtypes, master copy and rounding differ from the
reference's.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"   # bfloat16 halves optimizer memory
    master_fp32: bool = False      # keep fp32 master params (bf16 models)


def init_state(cfg: AdamWConfig, params: dict) -> dict:
    """{"step": int32 0, "m": zeros, "v": zeros[, "master": float32 copy]};
    ``m``, ``v`` and ``master`` take each parameter's layout (a DTensor
    parameter's placements, as the reference's ``_opt_specs`` mirror the
    parameter specs)."""
    sdt = getattr(torch, cfg.state_dtype)
    device = next(iter(params.values())).device
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": {n: torch.zeros_like(p, dtype=sdt, memory_format=torch.contiguous_format)
              for n, p in params.items()},
        "v": {n: torch.zeros_like(p, dtype=sdt, memory_format=torch.contiguous_format)
              for n, p in params.items()},
    }
    if cfg.master_fp32:
        state["master"] = {n: p.detach().to(torch.float32, copy=True)
                           for n, p in params.items()}
    return state


def _norm(tensors: list) -> torch.Tensor:
    """sqrt of the sum of squares of float32 tensors.

    DTensors take the same fused per-tensor norm on their local shards
    (a partial sum reduced first), the squares summed over the mesh
    dimensions that shard each; the result is
    a plain tensor, the same on every rank (and bit-equal to the plain
    path's on a one-rank mesh, where DTensor's own ``_foreach_norm``
    reduces in another order on the card)."""
    if not tensors:
        return torch.zeros(())
    if not _is_dtensor(tensors[0]):
        return torch.stack(torch._foreach_norm(tensors)).square().sum().sqrt()
    from torch.distributed.tensor import DTensor, Partial, Replicate

    tensors = [t.redistribute(t.device_mesh, [Replicate() if pl.is_partial() else pl
                                              for pl in t.placements])
               if any(pl.is_partial() for pl in t.placements) else t for t in tensors]
    norms = torch._foreach_norm([t.to_local() for t in tensors])
    squares = []
    for n, t in zip(norms, tensors):
        sq = n.square()
        if any(pl.is_shard() for pl in t.placements):
            sq = DTensor.from_local(sq, t.device_mesh, [
                Partial() if pl.is_shard() else Replicate() for pl in t.placements],
                run_check=False).full_tensor()
        squares.append(sq)
    return torch.stack(squares).sum().sqrt()


def _is_dtensor(t) -> bool:
    if type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


@torch.no_grad()
def global_norm(tree: dict) -> torch.Tensor:
    """The float32 L2 norm over every tensor of ``tree``."""
    return _norm([g.float() for g in tree.values()])


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, grads: dict, state: dict, lr_scale=1.0):
    """One AdamW step.  Returns (new params, new state, metrics); the
    inputs are left as they were.  ``metrics`` holds the pre-clip
    ``grad_norm`` and the ``lr`` applied, as float32 tensors.

    With DTensor parameters every gradient and state tensor is laid out as
    its parameter, the norm taken across the shards, and the elementwise
    update runs on the local shards (the same fused ops as without a mesh;
    DTensor's own strategies for ``_foreach`` ops cost more host time than
    the step on a three-axis mesh); the results carry the parameters'
    placements."""
    names = list(params)
    if not _is_dtensor(params[names[0]]):
        return _update(cfg, params, grads, state, lr_scale,
                       _norm([grads[n].float() for n in names]))
    from torch.distributed.tensor import DTensor

    def like(t, p):
        if tuple(t.placements) != tuple(p.placements):
            t = t.redistribute(p.device_mesh, p.placements)
        return t

    grads = {n: like(grads[n], params[n]) for n in names}
    gnorm = _norm([grads[n].float() for n in names])
    trees = {k: state[k] for k in ("m", "v", "master") if k in state}
    local = lambda tree: {n: like(tree[n], params[n]).to_local() for n in names}
    new, new_state, metrics = _update(
        cfg, local(params), local(grads),
        {"step": state["step"], **{k: local(t) for k, t in trees.items()}}, lr_scale, gnorm)

    def wrap(tree):
        return {n: DTensor.from_local(tree[n], params[n].device_mesh, params[n].placements,
                                      run_check=False, shape=params[n].shape,
                                      stride=params[n].stride()) for n in names}

    return wrap(new), {k: (v if k == "step" else wrap(v)) for k, v in new_state.items()}, metrics


def _update(cfg: AdamWConfig, params: dict, grads: dict, state: dict, lr_scale, gnorm):
    """``apply_updates`` on plain tensors, given the gradients' norm."""
    names = list(params)
    step = state["step"] + 1
    g = [grads[n].float() for n in names]
    if cfg.grad_clip:
        g = torch._foreach_mul(g, torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0))
    sdt = getattr(torch, cfg.state_dtype)
    stepf = step.float()
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)
    lr = torch.as_tensor(cfg.lr * lr_scale, dtype=torch.float32, device=gnorm.device)

    m32 = torch._foreach_mul([state["m"][n].float() for n in names], cfg.b1)
    torch._foreach_add_(m32, torch._foreach_mul(g, 1 - cfg.b1))
    v32 = torch._foreach_mul([state["v"][n].float() for n in names], cfg.b2)
    torch._foreach_add_(v32, torch._foreach_mul(torch._foreach_mul(g, g), 1 - cfg.b2))
    denom = torch._foreach_sqrt(torch._foreach_div(v32, b2c))
    torch._foreach_add_(denom, cfg.eps)
    upd = torch._foreach_div(torch._foreach_div(m32, b1c), denom)
    base = state["master"] if cfg.master_fp32 else params
    base32 = [base[n].float() for n in names]
    torch._foreach_add_(upd, torch._foreach_mul(base32, cfg.weight_decay))
    torch._foreach_mul_(upd, lr)
    new32 = torch._foreach_sub(base32, upd)

    new_params = {n: x.to(params[n].dtype) for n, x in zip(names, new32)}
    new_state = {"step": step,
                 "m": {n: x.to(sdt) for n, x in zip(names, m32)},
                 "v": {n: x.to(sdt) for n, x in zip(names, v32)}}
    if cfg.master_fp32:
        new_state["master"] = dict(zip(names, new32))
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


def cosine_schedule(step, *, base_lr=1.0, warmup=100, total=10000, min_frac=0.1):
    """LR scale factor (multiply by cfg.lr): linear warmup, then cosine to
    ``min_frac``.  As in the reference it is 0 at step 0, and the train step
    takes it before the step's increment, so the first step applies lr 0."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos


__all__ = ["AdamWConfig", "apply_updates", "cosine_schedule", "global_norm", "init_state"]
