"""Mixture-of-Experts FFN: top-k routing, capacity dispatch, batched experts.

Counterpart of ``repro.models.moe``.  The router runs in float32: softmax,
top-k, the gates renormalised over the k choices (floor 1e-9), and the
Switch load-balance aux loss ``E * mean(top-1 fraction * mean prob)``.
Each expert takes at most ``capacity = min(max(1, ceil(T K / E * cf)), T)``
tokens of a dispatch group; the slots past it are dropped, add nothing and
leave the token on the residual path.

* :func:`moe_ffn` is the reference's sort-based dispatch of one (T, D)
  group: a stable argsort of the token-major (token, choice) slots, so an
  expert's capacity goes to the earliest tokens.
* :func:`moe_ffn_grouped` is the path the model takes: ``n_groups``
  groups (1 when B S is not a multiple of it), positions from the GShard
  cumsum with k-major priority (all first choices claim capacity before
  any second choice).  The reference dispatches and combines through
  one-hot ``(G, T, E, C)`` einsums, a device for GSPMD partitioning; here
  the same assignment gathers the kept tokens into ``(G, E, C, D)`` by
  index, the experts run as batched matrix products, and each token sums
  its kept expert rows weighted by its gates, in float32 from the gates
  rounded to the compute dtype (the reference's combine tensor), rounded
  once to the compute dtype.  No ``(G, T, E, C)`` tensor is built.

The expert products are plain batched matrix products, as in the
reference (no Pallas kernel there).

On a mesh (DTensor input) the layer runs as the reference's pins lay it
out, groups on dp and experts on ``model``: DTensor has no sharding
strategy for the dispatch's index gathers, so the whole expert region is
one ``local_map`` (the reference's ``shard_map`` counterpart,
:func:`_moe_sharded`).  Each rank routes its own groups with the whole
router and runs its own experts; the output is a partial sum over
``model``, reduced at the region's exit, and the aux a mean over dp.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import gelu, init_dense, silu
from repro_torch.sharding.context import (
    clean_spec,
    constraint,
    is_dtensor,
    local_region,
    shard_start,
)


def init_moe(cfg, dtype, generator: torch.Generator, device=None) -> dict:
    """The reference's ``init_moe``: router float32 (d, E) at ``d ** -0.5``;
    ``w_gate``, ``w_up`` (E, d, f) and ``w_down`` (E, f, d), each normal
    scaled by its input width ``** -0.5`` (same distributions, not the
    same numbers), drawn from ``generator`` on ``device``."""
    m, d = cfg.moe, cfg.d_model
    dev = generator.device if device is None else torch.device(device)
    if dev != generator.device:
        raise ValueError(f"generator on {generator.device}, device {dev}")

    def shape3(a, b):
        w = torch.randn((m.n_experts, a, b), generator=generator, device=dev)
        return (w * a**-0.5).to(dtype)

    return {"router": init_dense(generator, d, m.n_experts, torch.float32),
            "w_gate": shape3(d, m.d_ff_expert), "w_up": shape3(d, m.d_ff_expert),
            "w_down": shape3(m.d_ff_expert, d)}


def moe_shapes(cfg) -> dict:
    """Parameter name -> (shape, float32?) of one MoE layer."""
    m, d = cfg.moe, cfg.d_model
    E, f = m.n_experts, m.d_ff_expert
    return {"router": ((d, E), True), "w_gate": ((E, d, f), False),
            "w_up": ((E, d, f), False), "w_down": ((E, f, d), False)}


class MoE(nn.Module):
    """The parameters of one MoE layer (``init_moe``), or uninitialised for
    ``load_state_dict`` without a generator; the router stays float32."""

    def __init__(self, cfg, dtype, device, generator: torch.Generator | None = None):
        super().__init__()
        if generator is not None:
            weights = init_moe(cfg, dtype, generator, device)
        else:
            weights = {name: torch.empty(shape, dtype=torch.float32 if f32 else dtype,
                                         device=device)
                       for name, (shape, f32) in moe_shapes(cfg).items()}
        for name, w in weights.items():
            self.register_parameter(name, nn.Parameter(w))


def capacity(tokens: int, cfg) -> int:
    """Slots per expert in a group of ``tokens``."""
    m = cfg.moe
    return min(max(1, math.ceil(tokens * m.top_k / m.n_experts * m.capacity_factor)), tokens)


def _route(x: torch.Tensor, router: torch.Tensor, cfg):
    """x (..., T, D) -> (gates (..., T, K) renormalised, expert ids
    (..., T, K) in descending probability, aux float32 scalar)."""
    m = cfg.moe
    E = m.n_experts
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    gates, idx = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    top1 = F.one_hot(idx[..., 0], E).float().mean(-2)
    aux = E * torch.mean(top1 * probs.mean(-2))
    return gates, idx, aux


def _act(cfg):
    return gelu if cfg.ffn_type == "geglu" else silu


def _experts(xe: torch.Tensor, params: Mapping, cfg, cdt) -> torch.Tensor:
    """xe (E, N, D) -> (E, N, D): each expert's gated FFN on its rows."""
    h = _act(cfg)(torch.bmm(xe, params["w_gate"].to(cdt))) * torch.bmm(
        xe, params["w_up"].to(cdt))
    return torch.bmm(h, params["w_down"].to(cdt))


def moe_ffn(x: torch.Tensor, params: Mapping, cfg, compute_dtype=torch.bfloat16):
    """x (T, D), one dispatch group -> (y (T, D) in ``compute_dtype``, aux).

    The reference's sort-based dispatch: token-major slot order, a stable
    argsort by expert, each expert's first ``capacity`` slots kept."""
    m = cfg.moe
    T, D = x.shape
    E, K = m.n_experts, m.top_k
    cap = capacity(T, cfg)
    dev = x.device
    gates, idx, aux = _route(x, params["router"], cfg)
    flat_expert = idx.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    st = torch.arange(T, device=dev).repeat_interleave(K)[order]
    sg = gates.reshape(-1)[order]
    start = torch.searchsorted(se, torch.arange(E + 1, device=dev), side="left")
    pos = torch.arange(T * K, device=dev) - start[se]
    keep = pos < cap
    # Slot (expert, position) of each kept routed token; dropped ones land
    # in a spare row E that is cut off.
    cell = torch.where(keep, se * cap + pos, E * cap)
    buf_tok = torch.zeros(E * cap + 1, dtype=torch.long, device=dev).scatter(
        0, cell, torch.where(keep, st, 0))[:-1].view(E, cap)
    buf_gate = torch.zeros(E * cap + 1, dtype=sg.dtype, device=dev).scatter(
        0, cell, torch.where(keep, sg, 0.0))[:-1].view(E, cap)
    buf_valid = torch.zeros(E * cap + 1, dtype=torch.bool, device=dev).scatter(
        0, cell, keep)[:-1].view(E, cap)
    xin = x.to(compute_dtype)[buf_tok] * buf_valid[..., None].to(compute_dtype)
    yexp = _experts(xin, params, cfg, compute_dtype)
    yexp = yexp * buf_gate[..., None].to(compute_dtype)
    y = torch.zeros((T, D), dtype=compute_dtype, device=dev).index_add(
        0, buf_tok.reshape(-1), yexp.reshape(E * cap, D))
    return y, aux.float()


class Assignment(NamedTuple):
    """Where each (token, choice) of a grouped dispatch goes: ``G`` groups
    of ``T`` tokens, ``cap`` slots an expert; per (G, T, K) the renormalised
    gate, the expert, the position in the expert and whether it was kept."""

    G: int
    T: int
    cap: int
    gates: torch.Tensor
    idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor


def assign(x: torch.Tensor, router: torch.Tensor, cfg, n_groups: int | None = None) -> Assignment:
    """The grouped dispatch's routing of x (B, S, D): groups, gates, and the
    GShard positions with k-major priority: the choices taken k-major, a
    choice's position is the count of earlier choices of its expert (one
    cumsum along the innermost axis of the (G, E, K T) one-hot: along an
    outer axis the scan took 45 ms a layer on an H100 at 131072 choices).
    ``n_groups`` overrides the config's group count."""
    m = cfg.moe
    B, S, D = x.shape
    G = n_groups or m.n_groups
    G = G if (B * S) % G == 0 else 1
    T = B * S // G
    E, K = m.n_experts, m.top_k
    gates, idx, aux = _route(x.reshape(G, T, D), router, cfg)
    flat = idx.transpose(1, 2).reshape(G, 1, K * T)                   # k-major
    onehot = flat == torch.arange(E, device=x.device).view(1, E, 1)   # (G, E, K T)
    counts = torch.cumsum(onehot, dim=-1, dtype=torch.int32)
    pos = counts.gather(1, flat).view(G, K, T).transpose(1, 2) - 1    # (G, T, K)
    cap = capacity(T, cfg)
    return Assignment(G, T, cap, gates, idx, pos, pos < cap, aux)


def moe_ffn_grouped(x: torch.Tensor, params: Mapping, cfg, compute_dtype=torch.bfloat16):
    """x (B, S, D) -> (y (B, S, D) in ``compute_dtype``, aux float32)."""
    if is_dtensor(x):
        return _moe_sharded(x, params, cfg, compute_dtype)
    return _moe_grouped(x, params, cfg, compute_dtype)


def _moe_grouped(x, params: Mapping, cfg, compute_dtype, n_groups: int | None = None,
                 first_expert: int = 0):
    """The grouped dispatch on plain tensors.  ``params``' experts may be a
    slice, experts ``first_expert`` on: the choices of other experts add
    nothing (the output is then this slice's part of the sum)."""
    B, S, D = x.shape
    E = params["w_gate"].shape[0]
    a = assign(x, params["router"], cfg) if n_groups is None else \
        assign(x, params["router"], cfg, n_groups)
    G, T, cap = a.G, a.T, a.cap
    dev = x.device
    n_slots = G * E * cap
    # Slot of each (token, choice): group, expert, position; the dropped
    # ones (and another slice's experts) point at spare slot n_slots.
    group = torch.arange(G, device=dev).view(G, 1, 1)
    local, mine = a.idx, a.keep
    if first_expert or E != cfg.moe.n_experts:  # a slice of the experts (on a mesh)
        local = a.idx - first_expert
        mine = mine & (local >= 0) & (local < E)
    slot = torch.where(mine, (group * E + local) * cap + a.pos, n_slots)
    # Each kept slot's token row of x (flattened with a zero row at G T for
    # the slots nobody claimed), gathered into (E, G cap, D).
    rows = (group * T + torch.arange(T, device=dev).view(1, T, 1)).expand_as(slot)
    slot_row = torch.full((n_slots + 1,), G * T, dtype=torch.long, device=dev).scatter(
        0, slot.reshape(-1), rows.reshape(-1))[:-1]
    xflat = torch.cat([x.reshape(G * T, D).to(compute_dtype),
                       x.new_zeros((1, D), dtype=compute_dtype)])
    xe = xflat.index_select(0, slot_row).view(G, E, cap, D).transpose(0, 1)
    ye = _experts(xe.reshape(E, G * cap, D), params, cfg, compute_dtype)
    yflat = torch.cat([ye.view(E, G, cap, D).transpose(0, 1).reshape(n_slots, D),
                       ye.new_zeros((1, D))])
    picked = yflat.index_select(0, slot.reshape(-1)).view(G, T, -1, D)
    w = torch.where(mine, a.gates, 0.0).to(compute_dtype).float()
    y = (picked.float() * w[..., None]).sum(2).to(compute_dtype)
    return y.view(B, S, D), a.aux.float()


def _moe_sharded(x, params: Mapping, cfg, compute_dtype):
    """The grouped dispatch on a mesh, as one ``local_map`` region: groups
    on dp (each rank's batch shard holds whole groups when the groups
    divide over dp; else the tokens are gathered), experts on ``model``
    when they divide it (else every rank runs them all).  Each rank's
    output is its experts' part of the sum, reduced over ``model`` at
    the exit; the aux is its groups' mean, averaged over dp."""
    from torch.distributed.tensor import Partial, Replicate

    from repro_torch.sharding.rules import mesh_shape_of, placements

    mesh = x.device_mesh
    sizes = mesh_shape_of(mesh)
    dp = clean_spec((("pod", "data"),), mesh.mesh_dim_names)[0] or ()
    n_dp = 1
    for axis in dp:
        n_dp *= sizes[axis]
    B, S, _ = x.shape
    G = cfg.moe.n_groups if (B * S) % cfg.moe.n_groups == 0 else 1
    split = bool(dp) and B % n_dp == 0 and G % n_dp == 0
    n_model = sizes.get("model", 1)
    E = cfg.moe.n_experts
    ep = E % n_model == 0 and n_model > 1
    first = shard_start(mesh, "model", E) if ep else 0
    x_spec = (dp if split else None, None, None)
    w_spec = ("model" if ep else None, None, None)
    x_pl = placements(x_spec, mesh)
    y_pl = [Partial() if (ep and name == "model") else pl
            for name, pl in zip(mesh.mesh_dim_names, x_pl)]
    # The aux is a mean over the groups, each rank's share a partial sum
    # (so that its gradient reaches each rank's router copy once).
    aux_pl = [Partial() if (split and name in dp) or (ep and name == "model") else Replicate()
              for name in mesh.mesh_dim_names]
    n_parts = (n_dp if split else 1) * (n_model if ep else 1)

    def body(xl, router, wg, wu, wd):
        y, aux = _moe_grouped(xl, {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd},
                              cfg, compute_dtype, n_groups=G // n_dp if split else G,
                              first_expert=first)
        return y, aux / n_parts

    y, aux = local_region(
        body, (x, params["router"], params["w_gate"], params["w_up"], params["w_down"]),
        (x_spec, (None, None), w_spec, w_spec, w_spec), outs=(y_pl, aux_pl))
    return constraint(y, ("pod", "data"), None, None), aux


__all__ = ["Assignment", "MoE", "assign", "capacity", "init_moe", "moe_ffn", "moe_ffn_grouped",
           "moe_shapes"]
