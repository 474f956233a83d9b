"""Dry-run cell construction: (arch x shape x mesh) -> one step's
per-device counts; counterpart of ``repro.launch.cells``.

Shared by ``launch/dryrun.py`` (the 16x16 and 2x16x16 production meshes
on a fake world of 512 ranks) and the dry-run tests (small meshes).  A
cell's parameters, optimizer state, batch and decode state are DTensors
made with ``DTensor.from_local`` on fake local shards, under one
``FakeTensorMode``: nothing is allocated and nothing is sent.  The step
then runs eagerly on them (``analyze_cell``) under that mode, an
:class:`OpCounter`, which counts what one rank does: the local ops DTensor issues (a counter
outside DTensor sees the global op), so replicated and redundant work
counts on every device, which is what ``useful_ratio`` measures.

The port's blocks are a Python loop (no ``lax.scan``), so a full-depth
count is already exact; ``analyze_cell_extrapolated`` counts the full
depth and still reports the per-group cost from two shallow builds, and
``estimate_step_time`` keeps the reference's two shallow probes and
secant extrapolation, which keeps the tuner cheap.  Nothing touches a
process group at import.
"""

from __future__ import annotations

import dataclasses
import sys
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ModelConfig, SHAPES, get_config, input_specs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import costmodel
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.sharding import layout, rules
from repro_torch.sharding.context import is_dtensor, use_mesh
from repro_torch.train import step as step_mod


@dataclasses.dataclass(frozen=True)
class CellConfig:
    """Per-cell runtime knobs (the §Perf hillclimb levers)."""

    remat: str = "full"
    logits_chunk: int = 0
    microbatch: int = 1
    fsdp: bool = False
    unroll_layers: bool = False    # shallow probes set this (see analyze)
    opt_state_dtype: str = "float32"
    master_fp32: bool = False
    cache_dtype: str = "bfloat16"
    moe_n_groups: int | None = None   # override cfg.moe.n_groups


def default_cell_config(cfg: ModelConfig, shape: ShapeConfig) -> CellConfig:
    """Baseline knobs: remat-full for train, FSDP for >16B-total archs.

    The FSDP threshold (bf16 weights over 32 GB) is the reference's rule,
    kept so that both packages lay the same cells out; it is not derived
    from this card's memory."""
    if shape.kind == "train":
        return CellConfig(
            remat="full",
            fsdp=cfg.total_params() * 2 > 32e9,
        )
    return CellConfig(remat="none")


def _apply_overrides(cfg: ModelConfig, cell: CellConfig, mesh) -> ModelConfig:
    if cfg.moe is not None:
        # default dispatch groups = number of data shards, so each group is
        # shard-local at the production sharding
        mesh_shape = rules.mesh_shape_of(mesh)
        dp_total = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
        n_groups = cell.moe_n_groups or dp_total
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, n_groups=n_groups)
        )
    return cfg


def _mesh_axes(mesh) -> rules.MeshAxes:
    """("pod", "data") are the dp axes on a multi-pod mesh, else "data"."""
    return rules.mesh_axes(mesh)


def build_cell(arch: str, shape_name: str, mesh, *,
               cell: CellConfig | None = None, cfg: ModelConfig | None = None):
    """Build one dry-run cell: a dict with ``run`` (the step, to call under
    ``fake_mode``), ``fake_mode`` (its :class:`OpCounter`), ``args`` (the step's inputs: DTensors on
    fake shards) and ``meta``."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    cell = cell or default_cell_config(cfg, shape)
    cfg = _apply_overrides(cfg, cell, mesh)
    axes = _mesh_axes(mesh)

    step_cfg = step_mod.StepConfig(
        remat=cell.remat,
        logits_chunk=cell.logits_chunk,
        microbatch=cell.microbatch,
        cache_dtype=cell.cache_dtype,
        unroll_layers=cell.unroll_layers,
    )
    mesh_shape = rules.mesh_shape_of(mesh)
    fake_mode = OpCounter()
    dev = mesh.device_type
    with fake_mode:
        model = tf.Transformer(cfg, device="meta")
        params_like = dict(model.named_parameters())
        param_spec = rules.param_specs(params_like, axes, fsdp=cell.fsdp,
                                       mesh_shape=mesh_shape)
        layout.shard_module(model, mesh, param_spec, fake=True)
        batch_shapes = input_specs(cfg, shape)
        batch_like = {k: torch.empty(s, device="meta") for k, (s, _) in batch_shapes.items()}
        batch_spec = rules.batch_specs(batch_like, axes, mesh_shape=mesh_shape)
        batch = {k: layout.fake_like(s, dt, mesh, batch_spec[k])
                 for k, (s, dt) in batch_shapes.items()}

    meta = {
        "arch": cfg.name,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": dict(mesh_shape),
        "cell_config": dataclasses.asdict(cell),
        "total_params": cfg.total_params(),
        "active_params": cfg.active_params(),
    }

    if shape.kind == "train":
        optim_cfg = adamw.AdamWConfig(
            state_dtype=cell.opt_state_dtype, master_fp32=cell.master_fp32
        )
        with fake_mode, use_mesh(mesh):
            opt_state = adamw.init_state(optim_cfg, dict(model.named_parameters()))
        fn = step_mod.build_train_step(cfg, optim_cfg, step_cfg)
        args = (model, opt_state, batch)
        meta["model_flops"] = train_model_flops(cfg, shape)
    elif shape.kind == "prefill":
        fn = step_mod.build_prefill_step(cfg, shape.seq_len, step_cfg)
        args = (model, batch)
        meta["model_flops"] = serve_model_flops(cfg, shape, prefill=True)
    elif shape.kind == "decode":
        fn = step_mod.build_decode_step(cfg, step_cfg)
        with fake_mode:
            state = tf.init_sharded_decode_state(
                cfg, shape.global_batch, shape.seq_len, mesh,
                getattr(torch, step_cfg.cache_dtype), device=dev)
        args = (model, state, batch)
        meta["model_flops"] = serve_model_flops(cfg, shape, prefill=False)
    else:
        raise ValueError(shape.kind)

    def run():
        with use_mesh(mesh):
            return fn(*args)

    return {"run": run, "fake_mode": fake_mode, "args": args, "meta": meta}


# ---------------------------------------------------------------------------
# MODEL_FLOPS accounting (global, for the useful-compute ratio)
# ---------------------------------------------------------------------------


def train_model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6 * N_active * tokens (+ attention context flops)."""
    tokens = shape.global_batch * shape.seq_len
    base = 6.0 * cfg.active_params() * tokens
    base += 3.0 * _attention_context_flops(cfg, shape.seq_len, tokens)
    return base


def serve_model_flops(cfg: ModelConfig, shape: ShapeConfig,
                      *, prefill: bool) -> float:
    if prefill:
        tokens = shape.global_batch * shape.seq_len
        return (
            2.0 * cfg.active_params() * tokens
            + _attention_context_flops(cfg, shape.seq_len, tokens)
        )
    tokens = shape.global_batch  # one new token per sequence
    base = 2.0 * cfg.active_params() * tokens
    n_attn = sum(1 for k in cfg.layer_kinds() if k == "attn")
    hd = cfg.resolved_head_dim
    # decode attention: q @ K^T + p @ V over the full cache
    base += tokens * n_attn * cfg.n_heads * hd * shape.seq_len * 2 * 2
    return base


def _attention_context_flops(cfg: ModelConfig, seq: int,
                             tokens: float) -> float:
    """2 * (qk + pv) flops for causal attention over the sequence."""
    n_attn = sum(1 for k in cfg.layer_kinds() if k == "attn")
    hd = cfg.resolved_head_dim
    ctx = seq / 2 if cfg.causal else seq
    return tokens * n_attn * cfg.n_heads * hd * ctx * 2 * 2


# ---------------------------------------------------------------------------
# per-device counting
# ---------------------------------------------------------------------------


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class OpCounter(FakeTensorMode):
    """The fake mode a cell is built and run under, counting what one rank
    does while ``counting`` is set.

    An op on DTensors reaches this mode first as the global op and is
    passed on to DTensor (not counted); the local ops DTensor then issues
    on the fake shards, and the collectives of its redistributions, are
    the ones counted (the fake mode's own decompositions inside an op, and
    DTensor's shape propagation on global placeholders, are not).  Per
    local op: matrix-product flops (``torch.utils.flop_counter``'s
    formulas), unfused bytes (tensor inputs plus outputs; views and empty
    allocations move nothing), and for a ``_c10d_functional`` collective
    its output's bytes by kind.  Peak live bytes are a tally of the
    distinct storages of the tensors alive (those passed to :meth:`track`
    and every local op's outputs), freed when their last tracked tensor
    dies.
    """

    _SKIP = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                       "new_empty_strided", "wait_tensor", "device"})

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.counting = False
        self._depth = 0
        self.flops = 0
        self.bytes = 0
        self.records: list = []
        self.live = 0
        self.peak = 0
        self._storages: dict = {}   # storage id -> [bytes, tracked tensors]

    def track(self, t) -> None:
        """Count ``t``'s storage as live until ``t`` (and every other
        tracked tensor on it) dies."""
        if is_dtensor(t):
            t = t._local_tensor
        if not isinstance(t, torch.Tensor):
            return
        key = t.untyped_storage()._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [t.untyped_storage().nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if (not self.counting or self._depth or out is NotImplemented
                or func._opname in self._SKIP or _in_shape_propagation()):
            return out
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        if costmodel.collective_kind(func) is not None:
            self.records.append((func, sum(_nbytes(o) for o in outs)))
        elif not func.is_view:
            count = self._flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
            flat, _ = tree_flatten((args, kwargs))
            self.bytes += sum(_nbytes(a) for a in flat if isinstance(a, torch.Tensor))
            self.bytes += sum(_nbytes(o) for o in outs)
        else:
            return out
        for o in outs:
            self.track(o)
        return out


def _in_shape_propagation() -> bool:
    """Whether DTensor's sharding propagator is running an op on global
    placeholders to learn its output's shape (not work any rank does)."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        frame = frame.f_back
    return False


def _count(built) -> dict:
    """Run a built cell once, counting."""
    counter = built["fake_mode"]
    for t in _tensors(built["args"]):
        counter.track(t)
    argument_bytes = counter.live
    counter.counting = True
    try:
        with counter:
            out = built["run"]()
            del out
    finally:
        counter.counting = False
    return {
        "flops": float(counter.flops),
        "bytes": float(counter.bytes),
        "collectives": costmodel.parse_collectives(counter.records),
        "argument_bytes": argument_bytes,
        "peak_bytes": counter.peak,
    }


def _tensors(args):
    """The tensors a step's arguments hold: a model's parameters, dicts and
    lists of tensors, a decode state's layers."""
    out = []
    for a in args:
        if isinstance(a, torch.nn.Module):
            out.extend(p for p in a.parameters())
        elif isinstance(a, tf.DecodeState):
            out.extend(tree_flatten(a.layers)[0])
        else:
            out.extend(x for x in tree_flatten(a)[0] if isinstance(x, torch.Tensor))
    return out


def _raw_costs(counts: dict) -> dict:
    return {
        "flops": counts["flops"],
        "bytes": counts["bytes"],
        "collective_bytes": float(counts["collectives"].total_bytes),
        "collectives": counts["collectives"],
    }


def _memory(counts: dict) -> dict:
    return {
        "argument_bytes": counts["argument_bytes"],
        "output_bytes": 0,
        "temp_bytes": counts["peak_bytes"] - counts["argument_bytes"],
        "alias_bytes": 0,
        "peak_bytes": counts["peak_bytes"],
    }


def analyze_cell(built, *, n_devices: int, mesh=None):
    """Run one cell under the counter -> roofline report and memory."""
    counts = _count(built)
    report = costmodel.roofline_from_counts(
        counts["flops"], counts["bytes"], counts["collectives"], counts["peak_bytes"],
        n_devices, model_flops=built["meta"]["model_flops"],
    )
    return {
        "meta": built["meta"],
        "roofline": report.to_dict(),
        "memory": _memory(counts),
    }


def _probes(arch, shape_name, mesh, cell, cfg):
    """Raw costs (and the second's peak) of the 1- and 2-period builds."""
    probe_cell = dataclasses.replace(cell, unroll_layers=True)
    probes, peak = [], 0
    for depth_groups in (1, 2):
        cfg_p = dataclasses.replace(cfg, n_layers=depth_groups * cfg.pattern_period)
        counts = _count(build_cell(arch, shape_name, mesh, cell=probe_cell, cfg=cfg_p))
        probes.append(_raw_costs(counts))
        peak = counts["peak_bytes"]
    return probes, peak


def estimate_step_time(arch: str, shape_name: str, mesh, *,
                       cell: CellConfig | None = None,
                       cfg: ModelConfig | None = None) -> dict:
    """Cheap step-time estimate: shallow probes + extrapolation only (no
    full-depth run).  This is the profiler backend for the
    paper's-config->time autotuner over launcher knobs."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    cell = cell or default_cell_config(cfg, shape)
    n_rep = cfg.n_groups_of_layers
    (p1, p2), peak = _probes(arch, shape_name, mesh, cell, cfg)
    tot = {k: p1[k] + (n_rep - 1) * (p2[k] - p1[k])
           for k in ("flops", "bytes", "collective_bytes")}
    compute_s = tot["flops"] / costmodel.PEAK_FLOPS_BF16
    memory_s = tot["bytes"] / costmodel.HBM_BW
    collective_s = tot["collective_bytes"] / costmodel.ICI_BW
    return {
        "step_s": max(compute_s, memory_s) + collective_s,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "probe2_peak_bytes": peak,
    }


def analyze_cell_extrapolated(arch: str, shape_name: str, mesh, *,
                              cell: CellConfig | None = None,
                              cfg: ModelConfig | None = None):
    """Depth-exact roofline of one cell.

    The reference compiles two shallow unrolled probes (1 and 2 periods)
    and extrapolates, because XLA costs a scanned body once.  The port's
    layers are a Python loop, so the full-depth run's counts are exact and
    are the report; the two shallow probes still give
    ``probe_group_cost`` (one period's cost), as in the reference.
    """
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    cell = cell or default_cell_config(cfg, shape)
    n_devices = mesh.size()

    built_full = build_cell(arch, shape_name, mesh, cell=cell, cfg=cfg)
    counts = _count(built_full)
    (p1, p2), _ = _probes(arch, shape_name, mesh, cell, cfg)
    model_flops = built_full["meta"]["model_flops"]
    report = costmodel.roofline_from_counts(
        counts["flops"], counts["bytes"], counts["collectives"], counts["peak_bytes"],
        n_devices, model_flops=model_flops,
    )
    return {
        "meta": built_full["meta"],
        "roofline": report.to_dict(),
        "probe_group_cost": {
            k: p2[k] - p1[k] for k in ("flops", "bytes", "collective_bytes")
        },
        "scan_compile_costs": _raw_costs(counts) | {"collectives": None},
        "memory": _memory(counts),
    }


__all__ = ["CellConfig", "OpCounter", "analyze_cell", "analyze_cell_extrapolated",
           "build_cell", "default_cell_config", "estimate_step_time", "serve_model_flops",
           "train_model_flops"]
