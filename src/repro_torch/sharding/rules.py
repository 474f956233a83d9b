"""Partition specs: DP / FSDP / TP / EP / SP over the (pod, data, model)
production mesh; counterpart of ``repro.sharding.rules``.

A spec is a tuple with one entry per tensor dimension: ``None``
(replicated), a mesh axis name, or a tuple of axis names (the dimension
split over several axes, the first one major).  Entries compare equal to
the reference's ``PartitionSpec`` entries.  :func:`placements` turns a
spec into DTensor placements on a mesh.

``param_specs(params, axes, fsdp=...)`` assigns a spec to every parameter
by name (``model.named_parameters()``'s ``.``-joined names; the first rule
that matches wins):

* TP: attention heads, the FFN's hidden width and the vocabulary on ``model``;
* EP: the MoE expert dimension on ``model``;
* FSDP: the largest axis still unsharded additionally on ``data`` (ZeRO-3).

The port's blocks are a Python loop, one module a layer, so there is no
stacked leading repeat axis: a layer's spec is the reference's
``blocks/pos{l % period}`` spec without its leading ``None``.  Batches
ride on the dp axes (``("pod", "data")`` multi-pod, else ``"data"``);
KV caches shard batch on dp and kv heads on ``model``.
"""

from __future__ import annotations

import dataclasses
import re

@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: tuple[str, ...] = ("data",)   # dp axes (includes "pod" if present)
    model: str = "model"
    fsdp: str = "data"                  # axis used for ZeRO param sharding

    @property
    def dp(self) -> tuple[str, ...]:
        return self.data


# (name regex, spec).  First match wins; the order is the reference's,
# so ``in_proj$`` catches ``mamba.in_proj`` before its own rule does.
_RULES: list[tuple[str, tuple]] = [
    (r"(^|\.)embed$",             ("model", None)),     # vocab-sharded embed
    (r"lm_head$",                 (None, "model")),     # column-parallel unembed
    (r"in_proj$",                 (None, "model")),     # frontend proj / mamba in
    (r"attn\.w[qkv]$",            (None, "model")),
    (r"attn\.wo$",                ("model", None)),
    (r"(q|k)_norm$",              (None,)),
    (r"ffn\.w_(gate|up)$",        (None, "model")),
    (r"ffn\.w_down$",             ("model", None)),
    (r"moe\.router$",             (None, None)),
    (r"moe\.w_(gate|up)$",        ("model", None, None)),   # EP: experts
    (r"moe\.w_down$",             ("model", None, None)),
    (r"mamba\.in_proj$",          (None, "model")),
    (r"mamba\.conv_w$",           (None, "model")),
    (r"mamba\.conv_b$",           ("model",)),
    (r"mamba\.x_proj$",           ("model", None)),
    (r"mamba\.dt_bias$",          ("model",)),
    (r"mamba\.A_log$",            ("model", None)),
    (r"mamba\.D$",                ("model",)),
    (r"mamba\.out_proj$",         ("model", None)),
    (r"rwkv\.mix$",               (None, None)),
    (r"rwkv\.w[rkvg]$",           (None, "model")),
    (r"rwkv\.wo$",                ("model", None)),
    (r"rwkv\.w0$",                ("model",)),
    (r"rwkv\.wA$",                (None, None)),
    (r"rwkv\.wB$",                (None, "model")),
    (r"rwkv\.u$",                 (None, None)),   # (H, hs): H=40 not 16-divisible
    (r"rwkv\.ln_w$",              (None, None)),
    (r"rwkv\.cm_k$",              (None, "model")),
    (r"rwkv\.cm_v$",              ("model", None)),
    (r"rwkv\.cm_r$",              (None, "model")),
    (r"norm\d?$",                 (None,)),
    (r"final_norm$",              (None,)),
]


def _base_spec(name: str) -> tuple | None:
    for pat, spec in _RULES:
        if re.search(pat, name):
            return spec
    return None


def _apply_fsdp(spec: list, shape: tuple[int, ...], axes: MeshAxes,
                min_size: int) -> list:
    """Shard the largest still-unsharded axis on the fsdp axis."""
    if axes.fsdp in spec:
        return spec
    cand = [
        (shape[i], i) for i in range(len(spec))
        if spec[i] is None and shape[i] >= min_size
    ]
    if not cand:
        return spec
    _, idx = max(cand)
    spec[idx] = axes.fsdp
    return spec


def _axis_size(mesh_shape: dict | None, axis) -> int:
    if mesh_shape is None:
        return 1  # unknown -> assume divisible (caller validates)
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= mesh_shape.get(a, 1)
        return n
    return mesh_shape.get(axis, 1)


def _sanitize(spec: list, shape: tuple, mesh_shape: dict | None) -> list:
    """Drop axis assignments whose dimension isn't shard-divisible."""
    out = []
    for s, dim in zip(spec, shape):
        if s is None:
            out.append(None)
        elif dim % _axis_size(mesh_shape, s) == 0:
            out.append(s)
        else:
            out.append(None)
    return out


def param_specs(params: dict, axes: MeshAxes = MeshAxes(), *,
                fsdp: bool = False, fsdp_min_size: int = 1024,
                mesh_shape: dict | None = None) -> dict:
    """{name: spec} for ``params`` ({name: anything with a ``shape``}).

    ``mesh_shape`` ({axis: size}) enables divisibility sanitization: any
    assignment whose dimension doesn't divide evenly degrades to None.  A
    name no rule matches is replicated.
    """
    out = {}
    for name, leaf in params.items():
        shape = tuple(leaf.shape)
        base = _base_spec(name)
        if base is None:
            base = (None,) * len(shape)
        spec = [b if b != "model" else axes.model for b in base]
        spec = _sanitize(spec, shape, mesh_shape)
        if fsdp:
            spec = _apply_fsdp(list(spec), shape, axes, fsdp_min_size)
            spec = _sanitize(spec, shape, mesh_shape)
        if len(spec) != len(shape):
            raise ValueError(
                f"spec rank mismatch at {name}: spec {spec} vs shape {shape}")
        out[name] = tuple(spec)
    return out


def _dp_entry(axes: MeshAxes):
    return axes.dp if len(axes.dp) > 1 else axes.dp[0]


def batch_specs(batch_like: dict, axes: MeshAxes = MeshAxes(),
                mesh_shape: dict | None = None) -> dict:
    """Batch inputs: leading (global batch) dim on the dp axes.

    If the batch doesn't divide (e.g. long_500k B=1), the dp assignment is
    dropped; the sequence axis picks up (data, model) sequence parallelism
    in the decode-state specs instead.  Leaves need a ``shape``.
    """
    dp = _dp_entry(axes)
    return {name: tuple(_sanitize([dp] + [None] * (len(leaf.shape) - 1),
                                  tuple(leaf.shape), mesh_shape))
            for name, leaf in batch_like.items()}


def _kv_spec(shape: tuple, axes: MeshAxes = MeshAxes(),
            mesh_shape: dict | None = None) -> tuple:
    """One KV cache tensor (B, S_max, n_kv, hd): batch on dp; kv heads on
    model if divisible, else the *sequence* axis takes model; if the batch
    itself is unshardable (B = 1), the sequence takes (dp..., model)."""
    dp = _dp_entry(axes)
    m = axes.model

    def div(dim: int, axis) -> bool:
        return dim % _axis_size(mesh_shape, axis) == 0

    B, S, H, _ = shape
    batch_ok = div(B, dp)
    spec = [dp if batch_ok else None, None, None, None]
    if batch_ok and div(H, m):
        spec[2] = m
    elif batch_ok and div(S, m):
        spec[1] = m
    elif not batch_ok:
        seq_axes = tuple((list(dp) if isinstance(dp, tuple) else [dp]) + [m])
        if div(S, seq_axes):
            spec[1] = seq_axes
        elif div(S, m):
            spec[1] = m
    return tuple(_sanitize(spec, shape, mesh_shape))


def decode_state_specs(layers: list, axes: MeshAxes = MeshAxes(),
                       mesh_shape: dict | None = None) -> list:
    """Specs of a ``DecodeState.layers`` list (or anything shaped like it),
    layer by layer, with divisibility-aware fallbacks:

      attn (k, v) : (B, S_max, n_kv, hd)  see :func:`_kv_spec`
      mamba h     : (B, d_in, ds)         batch dp, channels model
      mamba conv  : (B, k-1, d_in)        batch dp, channels model
      rwkv S      : (B, H, hs, hs)        batch dp, heads model if divisible
      x_prev_*    : (B, D)                batch dp, D model
    """
    dp = _dp_entry(axes)
    m = axes.model
    wanted = {"h": [dp, m, None], "conv": [dp, None, m], "S": [dp, m, None, None],
              "x_prev_tm": [dp, m], "x_prev_cm": [dp, m]}
    out = []
    for layer in layers:
        if isinstance(layer, (tuple, list)):
            out.append(tuple(_kv_spec(tuple(t.shape), axes, mesh_shape) for t in layer))
            continue
        out.append({key: tuple(_sanitize(wanted.get(key, [None] * len(t.shape)),
                                         tuple(t.shape), mesh_shape))
                    for key, t in layer.items()})
    return out


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: mesh dimension ``i``
    shards the tensor dimension whose entry names it, else replicates.
    Axes the mesh lacks are dropped.  ``(("pod", "data"), None, "model")``
    on a ``("pod", "data", "model")`` mesh gives ``[Shard(0), Shard(0),
    Shard(2)]``."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for dim, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                where[axis] = dim
    return [Shard(where[name]) if name in where else Replicate()
            for name in mesh.mesh_dim_names]


def opt_specs(opt_shapes: dict, param_spec: dict) -> dict:
    """Optimizer state specs mirror the param specs (m, v, master); the
    step count stays a plain tensor (None).  ``adamw.init_state`` on DTensor
    parameters makes a state laid out so; a checkpoint restore onto a mesh
    takes these specs (the reference's ``launch.cells._opt_specs``)."""
    spec = {
        "step": None,
        "m": param_spec,
        "v": param_spec,
    }
    if "master" in opt_shapes:
        spec["master"] = param_spec
    return spec


def mesh_shape_of(mesh) -> dict:
    """{axis name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axes(mesh) -> MeshAxes:
    """The dp axes are every axis but ``model`` (the reference's
    ``_mesh_axes``: ``("pod", "data")`` on a multi-pod mesh)."""
    names = tuple(mesh.mesh_dim_names)
    return MeshAxes(data=tuple(a for a in names if a != "model") or ("data",),
                    model="model")


__all__ = ["MeshAxes", "batch_specs", "decode_state_specs", "mesh_axes",
           "mesh_shape_of", "opt_specs", "param_specs", "placements"]
