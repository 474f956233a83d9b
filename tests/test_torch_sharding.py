"""The port's sharding rules, mesh-free pieces and cost model against the
reference's (``repro.sharding.rules``, ``repro.launch.cells``,
``repro.core.costmodel``, ``repro.core.tuner``).  No process group.

Leaves are paired through ``convert.lm_params_from_reference``'s name map:
each reference leaf is replaced by an array of leaf ids, one per stacked
repeat, and the map carries each id to the port's parameter name.  The
reference's stacked specs lose their leading ``None`` (the port's blocks
are a loop, one module a layer).
"""

from __future__ import annotations

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import applicable_shapes as j_applicable_shapes
from repro.configs import get_config as j_get_config
from repro.configs import input_specs as j_input_specs
from repro.configs import smoke_config as j_smoke_config
from repro.core import costmodel as jcost
from repro.core import tuner as jtuner
from repro.launch import cells as jcells
from repro.models import transformer as jtf
from repro.sharding import rules as jrules
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config, input_specs
from repro_torch.configs import smoke_config
from repro_torch.core import costmodel, mesh_factorizations
from repro_torch.launch import cells
from repro_torch.models import transformer as tf
from repro_torch.sharding import context, rules

MESH_SHAPES = [None, {"data": 4, "model": 3}, {"data": 4, "model": 4}]
MULTI_POD = (rules.MeshAxes(data=("pod", "data")), jrules.MeshAxes(data=("pod", "data")),
             {"pod": 2, "data": 2, "model": 4})


def test_arch_ids_match():
    assert tuple(ARCH_IDS) == tuple(J_ARCH_IDS)


def _ref_param_ids(arch):
    """The reference's parameter shapes and, per port parameter name, the
    (leaf id, stacked) of the reference leaf it comes from."""
    cfg = j_smoke_config(arch)
    shapes = jax.eval_shape(lambda k: jtf.init_params(cfg, k), jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    stacked = ["'blocks'" in p for p in paths]
    ids = [np.full((leaf.shape[0],), i, dtype=np.int64) if st else np.asarray(i, dtype=np.int64)
           for i, (leaf, st) in enumerate(zip(leaves, stacked))]
    named = convert.lm_params_from_reference(jax.tree_util.tree_unflatten(treedef, ids))
    return shapes, treedef, {n: (int(t), stacked[int(t)]) for n, t in named.items()}


def _pair(ref_specs_tree, treedef, name_ids):
    leaves = treedef.flatten_up_to(ref_specs_tree)
    out = {}
    for name, (i, st) in name_ids.items():
        spec = tuple(leaves[i])
        out[name] = spec[1:] if st else spec
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch):
    shapes, treedef, name_ids = _ref_param_ids(arch)
    port_params = dict(tf.Transformer(smoke_config(arch), device="meta").named_parameters())
    assert set(port_params) == set(name_ids)
    cases = [(rules.MeshAxes(), jrules.MeshAxes(), ms) for ms in MESH_SHAPES] + [MULTI_POD]
    n = 0
    for axes, jaxes, mesh_shape in cases:
        for fsdp in (False, True):
            kw = dict(fsdp=fsdp, fsdp_min_size=8, mesh_shape=mesh_shape)
            want = _pair(jrules.param_specs(shapes, jaxes, **kw), treedef, name_ids)
            got = rules.param_specs(port_params, axes, **kw)
            for name in port_params:
                assert got[name] == want[name], (arch, name, fsdp, mesh_shape)
                assert len(got[name]) == port_params[name].dim()
                n += 1
    assert n == len(port_params) * 2 * len(cases)


def test_a_leaf_no_rule_matches_is_replicated():
    """``rwkv.cm_mix`` has no rule, in the reference either."""
    specs = rules.param_specs({"blocks.0.rwkv.cm_mix": torch.empty(2, 64, device="meta")},
                              mesh_shape={"data": 2, "model": 2})
    assert specs["blocks.0.rwkv.cm_mix"] == (None, None)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_equal_the_reference(arch):
    cfg, jcfg = smoke_config(arch), j_smoke_config(arch)
    cases = [(rules.MeshAxes(), jrules.MeshAxes(), ms) for ms in MESH_SHAPES] + [MULTI_POD]
    for shape_name in applicable_shapes(cfg):
        for B in (SHAPES[shape_name].global_batch, 1, 6):
            shape = dataclasses.replace(SHAPES[shape_name], global_batch=B, seq_len=256)
            jshape = dataclasses.replace(J_SHAPES[shape_name], global_batch=B, seq_len=256)
            batch = {k: torch.empty(s, device="meta") for k, (s, _) in
                     input_specs(cfg, shape).items()}
            jbatch = j_input_specs(jcfg, jshape)
            assert {k: tuple(v.shape) for k, v in jbatch.items()} == \
                {k: tuple(v.shape) for k, v in batch.items()}
            for axes, jaxes, ms in cases:
                want = jrules.batch_specs(jbatch, jaxes, mesh_shape=ms)
                got = rules.batch_specs(batch, axes, mesh_shape=ms)
                assert got == {k: tuple(v) for k, v in want.items()}, (shape_name, B, ms)


def _state_pairs(arch, B, S, axes, jaxes, mesh_shape):
    """(port spec, reference spec without the stacked axis) of every decode
    state tensor."""
    cfg, jcfg = smoke_config(arch), j_smoke_config(arch)
    jstate = jax.eval_shape(lambda: jtf.init_decode_state(jcfg, B, S))
    jspecs = jrules.decode_state_specs(jstate["layers"], jaxes, mesh_shape=mesh_shape)
    layers = tf.init_decode_state(cfg, B, S, device="meta").layers
    specs = rules.decode_state_specs(layers, axes, mesh_shape)
    out = []
    for i, (layer, spec) in enumerate(zip(layers, specs)):
        js = jspecs[f"pos{i % cfg.pattern_period}"]
        kind = cfg.block_pattern[i % cfg.pattern_period]
        if kind == "attn":
            out += [(spec[0], tuple(js["kv"]["k"])[1:]), (spec[1], tuple(js["kv"]["v"])[1:])]
        else:
            for key in layer:
                out.append((spec[key], tuple(js[kind][key])[1:]))
    return out


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if smoke_config(a).causal])
def test_decode_state_specs_equal_the_reference(arch):
    """Every causal config (an encoder keeps no decode state)."""
    cases = [(rules.MeshAxes(), jrules.MeshAxes(), ms) for ms in MESH_SHAPES] + [MULTI_POD]
    n = 0
    for B, S in ((8, 64), (1, 256), (6, 96)):
        for axes, jaxes, ms in cases:
            for got, want in _state_pairs(arch, B, S, axes, jaxes, ms):
                assert got == want, (arch, B, S, ms)
                n += 1
    assert n > 0


def test_kv_fallback_hierarchy():
    """``test_dryrun_and_sharding.py``'s case: kv heads 2 on a 4-way model
    axis -> the sequence takes model."""
    layers = tf.init_decode_state(smoke_config("llama3-8b"), 8, 64, device="meta").layers
    specs = rules.decode_state_specs(layers, rules.MeshAxes(),
                                     mesh_shape={"data": 4, "model": 4})
    assert specs[0][0] == ("data", "model", None, None)


def test_batch1_sequence_parallel():
    """Batch 1: the sequence takes (data, model)."""
    cfg = smoke_config("jamba-v0.1-52b")
    layers = tf.init_decode_state(cfg, 1, 256, device="meta").layers
    specs = rules.decode_state_specs(layers, rules.MeshAxes(),
                                     mesh_shape={"data": 4, "model": 4})
    assert cfg.block_pattern[4] == "attn"
    assert specs[4][0] == (None, ("data", "model"), None, None)


def test_placements_on_a_three_axis_mesh():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert rules.placements((("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert rules.placements((None, ("data", "model")), mesh) == \
        [Replicate(), Shard(1), Shard(1)]
    assert rules.placements((), mesh) == [Replicate()] * 3
    two = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    assert rules.placements(context.clean_spec((("pod", "data"), "model"), ("data", "model")),
                            two) == [Shard(0), Shard(1)]


def test_constraint_is_a_no_op_without_a_mesh():
    x = torch.randn(4, 8)
    assert context.current_mesh() is None
    assert context.constraint(x, "data", "model") is x
    assert context.local_region(lambda a: a * 2, (x,), (("data", None),), outs=(0,)).equal(x * 2)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert applicable_shapes(cfg) == j_applicable_shapes(jcfg)
    for name in applicable_shapes(cfg):
        shape, jshape = SHAPES[name], J_SHAPES[name]
        if shape.kind == "train":
            assert cells.train_model_flops(cfg, shape) == jcells.train_model_flops(jcfg, jshape)
        else:
            pre = shape.kind == "prefill"
            assert cells.serve_model_flops(cfg, shape, prefill=pre) == \
                jcells.serve_model_flops(jcfg, jshape, prefill=pre)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_default_cell_config_equals_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name in applicable_shapes(cfg):
        assert dataclasses.asdict(cells.default_cell_config(cfg, SHAPES[name])) == \
            dataclasses.asdict(jcells.default_cell_config(jcfg, J_SHAPES[name]))


@pytest.mark.parametrize("n", [1, 12, 256, 512, 97])
@pytest.mark.parametrize("min_axis", [1, 2, 4])
def test_mesh_factorizations_equal_the_reference(n, min_axis):
    np.testing.assert_array_equal(mesh_factorizations(n, min_axis=min_axis),
                                  jtuner.mesh_factorizations(n, min_axis=min_axis))


def test_roofline_report_matches_the_reference():
    fields = dict(flops=3.0e12, hbm_bytes=4.0e11, collective_bytes=2.0e9, compute_s=0.01,
                  memory_s=0.02, collective_s=0.005, peak_hbm_bytes=1.0e10, dominant="memory",
                  model_flops=5.0e14, useful_ratio=0.6, n_devices=256)
    kinds = {"all-gather": 1, "all-reduce": 2, "reduce-scatter": 3, "all-to-all": 0,
             "collective-permute": 0}
    port = costmodel.RooflineReport(**fields, collectives=costmodel.CollectiveStats(
        dict(kinds), dict(kinds)))
    ref = jcost.RooflineReport(**fields, collectives=jcost.CollectiveStats(dict(kinds),
                                                                            dict(kinds)))
    a, b = port.to_dict(), ref.to_dict()
    assert list(a) == list(b)
    peak_dependent = {"roofline_fraction"}
    for key in a:
        if key not in peak_dependent:
            assert a[key] == b[key], key
    assert port.step_time_no_overlap == ref.step_time_no_overlap
    assert port.step_time_overlap == ref.step_time_overlap
    # the peak-dependent fraction scales with the two packages' peaks
    assert a["roofline_fraction"] * costmodel.PEAK_FLOPS_BF16 == \
        pytest.approx(b["roofline_fraction"] * jcost.PEAK_FLOPS_BF16, rel=1e-12)
    assert port.collectives.total_bytes == ref.collectives.total_bytes == 6
    assert costmodel.format_seconds(0.0123) == jcost.format_seconds(0.0123)


def test_roofline_from_counts_terms():
    coll = costmodel.parse_collectives([
        (torch.ops._c10d_functional.all_gather_into_tensor.default, 100),
        (torch.ops._c10d_functional.all_reduce.default, 50),
        (torch.ops._c10d_functional.wait_tensor.default, 999),
        (torch.ops.aten.mm.default, 7)])
    assert coll.bytes_by_kind == {"all-gather": 100, "all-reduce": 50, "reduce-scatter": 0,
                                  "all-to-all": 0, "collective-permute": 0}
    assert coll.total_count == 2
    r = costmodel.roofline_from_counts(989e12, 3.35e12, coll, 8e9, 4, model_flops=2e15)
    assert (r.compute_s, r.memory_s) == (1.0, 1.0)
    assert r.collective_s == 150 / costmodel.ICI_BW
    assert r.dominant == "compute"
    assert r.useful_ratio == 2e15 / (989e12 * 4)
    assert r.peak_hbm_bytes == 8e9


def test_h100_constants():
    assert costmodel.PEAK_FLOPS_BF16 == 989e12
    assert costmodel.HBM_BW == 3.35e12
    assert costmodel.ICI_BW == 450e9
    assert costmodel.HBM_BYTES == 80e9


def test_unroll_layers_is_accepted():
    from repro_torch.train import StepConfig

    assert StepConfig(unroll_layers=True).unroll_layers
    j = {f.name for f in dataclasses.fields(__import__("repro.train.step", fromlist=["x"])
                                             .StepConfig)}
    assert {f.name for f in dataclasses.fields(StepConfig)} == j
