"""Static per-phase flops and bytes estimates (counterpart of
``repro.telemetry.estimator``).

Wall-clock telemetry (``trace.py``) answers "what did this run cost"; this
module answers "what does the framework count each phase as costing" —
without running anything.  Each phase function of the canonical
:class:`repro_torch.mapreduce.ExecutionPlan` (the same stepper loops every
execution mode runs) is run once on shape-only tensors (``device="meta"``)
under two dispatch modes:

* :class:`torch.utils.flop_counter.FlopCounterMode` counts flops.  It has
  formulas for matrix products and convolutions only, so the MapReduce
  phases (sorts, gathers, scatters, elementwise integer work) count 0 or
  close to it, where the reference's XLA cost analysis on the CPU counts
  elementwise flops too.  A near-zero ``flops`` is the counter's scope,
  not a fault.
* a byte counter sums ``numel * element_size`` over every aten op's tensor
  inputs and outputs: an unfused "bytes accessed", as XLA's figure is.
  Views and bare allocations move no data and are skipped; an in-place
  op's result is its mutated input, counted once.  The hand-written
  kernels are opaque to the dispatcher; on meta tensors their wrappers
  return copies of their operands, so the count charges one read of each
  operand and one write of each result, the kernel's own traffic.

Each phase runs on its own shape-only arguments, so one phase that cannot
be estimated leaves the others alone: a phase that reads a value on the
host (``.item()``, ``.tolist()``; the all-to-all shuffle reads its live
block width) has no shape-only run and reports ``available=False`` with
zeroed numbers, as the reference reports a backend with no cost model.
Unlike the reference's, this estimator covers the ``combine`` phase when
``cfg.combiner``, with the shuffle's input sized by the combine capacity.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.mapreduce.phases import PAIR_BYTES
from repro_torch.mapreduce.plan import ExecutionPlan

__all__ = ["estimates_available", "stage_cost_estimates"]

_aten = torch.ops.aten
#: ops that are not views but move no data either
_MOVES_NO_DATA = frozenset({
    _aten.empty.memory_format, _aten.empty_like.default,
    _aten.empty_strided.default, _aten.new_empty.default,
    _aten._unsafe_view.default,
})


class _HostRead(Exception):
    """A phase asked for a value on the host, which meta tensors lack."""


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs; raises
    :class:`_HostRead` where an op would copy a value to the host."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _aten._local_scalar_dense.default or (
            func is _aten._to_copy.default
            and kwargs.get("device") not in (None, torch.device("meta"))
        ):
            raise _HostRead(str(func))
        out = func(*args, **kwargs)
        if func.is_view or func in _MOVES_NO_DATA:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
                and not any(t is i for i in ins)]
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        return out


def stage_cost_estimates(app, cfg, input_len: int) -> dict[str, dict]:
    """Per-phase {flops, bytes, flops_per_byte, available} from one
    shape-only run, plus static resource estimates (``cpu_flops``,
    ``net_bytes``).

    Phases are the plan's compute stages (map, combine when
    ``cfg.combiner``, shuffle, reduce); collect is host-side and has no
    phase function.  ``available=False`` (with zeroed numbers) means the
    phase reads the host and has no shape-only run.

    ``cpu_flops`` mirrors the flop count, as the reference's does;
    ``net_bytes`` is the shape-derived fabric upper bound — the shuffle's
    pair-slot capacity (``meta()["n_pairs"]``) times the wire pair size,
    zero for the other phases.  It pairs with the *measured* ``net_bytes``
    trace counter the way ``bytes`` pairs with measured wall times.
    """
    plan = ExecutionPlan(app, cfg, input_len, device="meta")
    stages = plan.phase_fns()
    meta = plan.meta()

    def shaped(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def task_rows(width):
        return (shaped(plan.M, width), shaped(plan.M, width),
                shaped(plan.M, width, dtype=torch.bool))

    part = (plan.R, meta["partition_capacity"])
    shape_args = {
        "map": (shaped(input_len),),
        "combine": task_rows(plan.P),
        "shuffle": task_rows(plan.shuffle_width),
        "reduce": (shaped(*part), shaped(*part)),
    }
    out: dict[str, dict] = {}
    for phase, fn in stages.items():
        counter = _ByteCounter()
        flop_mode = FlopCounterMode(display=False)
        try:
            with flop_mode, counter:
                fn(*shape_args[phase])
            available = True
        except _HostRead:
            available = False
        flops = float(flop_mode.get_total_flops()) if available else 0.0
        nbytes = float(counter.bytes) if available else 0.0
        out[phase] = {
            "flops": flops,
            "bytes": nbytes,
            "flops_per_byte": flops / nbytes if nbytes > 0 else 0.0,
            "available": available,
            "cpu_flops": flops,
            "net_bytes": (
                float(meta["n_pairs"] * PAIR_BYTES)
                if phase == "shuffle" else 0.0
            ),
        }
    return out


def estimates_available(estimates: dict[str, dict]) -> bool:
    """True when at least one phase has a shape-only estimate."""
    return any(e.get("available") for e in estimates.values())
