"""The port's static cost estimator (``repro_torch.telemetry.estimator``)
against the reference's, on the CPU.

The reference reads XLA's cost analysis; the port runs each phase function
once on meta tensors under ``FlopCounterMode`` and a byte-counting dispatch
mode, so the numbers differ by construction (``flops`` counts matrix
products only).  What must agree: the phases and keys, the exact
shape-derived ``net_bytes``, and availability.  The reference's estimator
raises ``KeyError`` on a combiner config (ROADMAP.md queue 3), so it is
compared with the combiner off only; the port's covers ``combine``.
"""

import dataclasses

import pytest
import torch

import repro.mapreduce as ref
import repro.telemetry as rtel
import repro_torch.mapreduce as port
from repro_torch.convert import (
    REFERENCE_BACKEND_NAMES,
    job_config_from_reference,
)
from repro_torch.kernels.local_reduce import local_reduce
from repro_torch.kernels.segment_reduce import segment_reduce
from repro_torch.telemetry import estimates_available, stage_cost_estimates

KEYS = {"flops", "bytes", "flops_per_byte", "available", "cpu_flops",
        "net_bytes"}
N = 4096


def _apps(name):
    if name == "wordcount":
        return ref.wordcount(256), port.wordcount(256)
    return ref.eximparse(64), port.eximparse(64)


def _cfgs(**kw):
    rcfg = ref.JobConfig(**{"num_mappers": 4, "num_reducers": 3,
                            "num_workers": 2, **kw})
    return rcfg, job_config_from_reference(dataclasses.asdict(rcfg))


@pytest.mark.parametrize("app", ["wordcount", "eximparse"])
@pytest.mark.parametrize("ref_backend", ["jnp", "xla", "pallas"])
def test_phases_keys_and_net_bytes_match_reference(app, ref_backend):
    rapp, papp = _apps(app)
    rcfg, pcfg = _cfgs(reduce_backend=ref_backend)
    assert pcfg.reduce_backend == REFERENCE_BACKEND_NAMES[ref_backend]
    want = rtel.stage_cost_estimates(rapp, rcfg, N)
    got = stage_cost_estimates(papp, pcfg, N)
    assert list(got) == list(want) == ["map", "shuffle", "reduce"]
    for phase in want:
        assert set(got[phase]) == set(want[phase]) == KEYS
        assert got[phase]["net_bytes"] == want[phase]["net_bytes"]
        assert got[phase]["available"] is True
        assert got[phase]["bytes"] > 0
        assert got[phase]["cpu_flops"] == got[phase]["flops"] >= 0
        assert got[phase]["flops_per_byte"] == pytest.approx(
            got[phase]["flops"] / got[phase]["bytes"])
    plan = port.ExecutionPlan(papp, pcfg, N, device="cpu")
    assert got["shuffle"]["net_bytes"] == plan.meta()["n_pairs"] * 8
    assert estimates_available(got) and estimates_available(want)


def _io_bytes(plan, phase):
    """The bytes of a phase's own inputs and outputs, from its shapes."""
    M, R, P = plan.M, plan.R, plan.P
    cap = plan.meta()["partition_capacity"]
    rows = lambda w: M * w * (4 + 4 + 1)  # noqa: E731  (keys, values, valid)
    return {
        "map": 4 * plan.input_len + rows(P),
        "combine": rows(P) + rows(plan.shuffle_width),
        "shuffle": rows(plan.shuffle_width) + 2 * 4 * R * cap,
        "reduce": 2 * (2 * 4 * R * cap),
    }[phase]


@pytest.mark.parametrize("backend", ["torch", "scatter_reduce", "cuda"])
@pytest.mark.parametrize("combiner", [False, True])
def test_bytes_cover_each_phase_io(backend, combiner):
    app = port.wordcount(64)  # P = 1024 per task > 64 keys: Pc = 64
    cfg = port.JobConfig(4, 3, 2, reduce_backend=backend, combiner=combiner)
    plan = port.ExecutionPlan(app, cfg, N, device="cpu")
    est = stage_cost_estimates(app, cfg, N)
    want = ["map", "combine", "shuffle", "reduce"] if combiner else \
        ["map", "shuffle", "reduce"]
    assert list(est) == want
    for phase, e in est.items():
        assert e["available"], phase
        assert e["bytes"] >= _io_bytes(plan, phase), phase
        assert e["net_bytes"] == (
            plan.meta()["n_pairs"] * 8 if phase == "shuffle" else 0.0)


def test_combiner_shrinks_the_shuffle_estimate():
    app = port.wordcount(64)
    off = stage_cost_estimates(app, port.JobConfig(4, 3, 2), N)
    on = stage_cost_estimates(app, port.JobConfig(4, 3, 2, combiner=True), N)
    assert on["map"] == off["map"]
    assert on["shuffle"]["bytes"] < off["shuffle"]["bytes"]
    assert on["reduce"]["bytes"] < off["reduce"]["bytes"]
    assert on["shuffle"]["net_bytes"] == off["shuffle"]["net_bytes"]


def test_phase_reading_the_host_is_unavailable():
    """The all-to-all shuffle reads its live block width on the host, so it
    has no shape-only run; the other phases still estimate."""
    app = port.wordcount(256)
    cfg = port.JobConfig(4, 3, 2, shuffle_backend="all_to_all")
    est = stage_cost_estimates(app, cfg, N)
    assert est["shuffle"] == {
        "flops": 0.0, "bytes": 0.0, "flops_per_byte": 0.0,
        "available": False, "cpu_flops": 0.0,
        "net_bytes": float(4 * 1024 * 8),
    }
    assert est["map"]["available"] and est["reduce"]["available"]
    assert estimates_available(est)
    assert not estimates_available({"shuffle": est["shuffle"]})


def test_kernels_launch_nothing_on_meta_tensors():
    before = segment_reduce.launches, local_reduce.launches
    app = port.wordcount(64)
    est = stage_cost_estimates(
        app, port.JobConfig(4, 3, 2, reduce_backend="cuda", combiner=True), N)
    assert all(e["available"] for e in est.values())
    assert (segment_reduce.launches, local_reduce.launches) == before
    k = torch.empty((3, 40), dtype=torch.int32, device="meta")
    for kernel in (segment_reduce, local_reduce):
        ok, ov = kernel(k, k)
        assert ok.shape == ov.shape == (3, 40) and ok.is_meta
