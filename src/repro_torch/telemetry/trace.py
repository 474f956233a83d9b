"""Per-phase execution traces (counterpart of ``repro.telemetry.trace``).

A copy of the reference module: it is framework-free apart from
``PAIR_BYTES``, which comes from the port's ``mapreduce.phases``, and the
serialized form is the same, so a trace written by either package loads
in the other.

A :class:`JobTrace` is one job execution decomposed into the engine's four
phases (map → shuffle → reduce → collect), each carrying a wall time and a
dict of resource counters (records/pairs moved, shuffle bytes, spill/drop
accounting, wave counts, segment-reduce work).  A :class:`PhaseRecorder`
accumulates traces across runs — thread one through
:func:`repro_torch.mapreduce.build_job` via its ``recorder=`` argument and
every call of the returned job appends a trace.

Telemetry is strictly opt-in: with ``recorder=None`` (the default) the
engine runs the usual fused pipeline and pays zero overhead.  With a
recorder, each phase is fenced (``torch.cuda.synchronize`` on the card) and
wall-clocked — same semantics, same outputs, slightly different timing
profile (the host waits for the device between phases), which is why
traced time is recorded per phase *and* as an outer total.

Counters are computed from the actual phase outputs, not from the
configuration, so conservation laws are real invariants:

* ``shuffle.bytes_in == shuffle.bytes_out + shuffle.bytes_dropped``
* ``map.pairs_emitted == shuffle.pairs_in`` — or, when a map-side combine
  stage ran, ``map.pairs_emitted == combine.pairs_in``,
  ``combine.pairs_out <= combine.pairs_in``, and
  ``combine.pairs_out == shuffle.pairs_in`` (the combiner is the only
  stage allowed to contract the pair stream, and it must do so between
  the map's emit counter and the shuffle's intake)
* per-phase wall times sum to ~the outer job wall time.

Resource counters extend the same discipline to CPU and fabric:

* ``cpu_s`` — process CPU-clock seconds sampled at the same fences as the
  wall clock, bounded per phase by ``wall_s * cpu_workers`` (the
  parallelism ceiling in effect when the sample was taken:
  ``os.cpu_count()`` on real engine fences, W on analytic traces);
* ``net_bytes`` / ``net_s`` — bytes entering the shuffle fabric and the
  seconds the transfer occupied it.  ``net_bytes == pairs_in * PAIR_BYTES``
  exactly (every emitted pair crosses the fabric, dropped ones included),
  and only the shuffle phase may carry non-zero ``net_bytes`` — bookkeeping
  phases (``pipeline``, ``contention``) must record it as zero.

``JobTrace.check_conservation`` verifies all of them and returns the list
of violations (empty = healthy); ``tests/test_torch_telemetry.py`` asserts
it stays empty for every reduce backend and holds the counters against the
reference's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Iterable

# One source of truth for the pair wire size (int32 key + int32 value):
# the engine's measured counters and the oracles' analytic counters must
# use the same constant or shuffle-bytes models silently diverge.
from repro_torch.mapreduce.phases import PAIR_BYTES

__all__ = [
    "PAIR_BYTES",
    "TRACE_SCHEMA_VERSION",
    "PhaseStats",
    "JobTrace",
    "PhaseRecorder",
    "collect_traced",
]

#: serialized-trace schema version.  Bump on breaking shape changes;
#: ``JobTrace.from_json`` refuses versions it does not understand instead
#: of silently misparsing them (traces now outlive the process — the span
#: exporter and bench artifacts persist them).
TRACE_SCHEMA_VERSION = 1


@dataclasses.dataclass
class PhaseStats:
    """One phase of one job execution: wall time + resource counters."""

    phase: str
    wall_s: float
    counters: dict[str, float] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "phase": self.phase,
            "wall_s": self.wall_s,
            "counters": dict(self.counters),
        }


@dataclasses.dataclass
class JobTrace:
    """One job execution, decomposed per phase.

    ``config`` carries the JobConfig fields plus ``input_len`` and the app
    name, so a trace is self-describing (it IS one row of the paper's
    experiment set, with the total broken into its parts).
    """

    app: str
    config: dict
    phases: list[PhaseStats] = dataclasses.field(default_factory=list)
    total_s: float | None = None

    # ---- recording (the engine-facing protocol) -------------------------

    def record_phase(self, phase: str, wall_s: float, **counters) -> None:
        self.phases.append(
            PhaseStats(
                phase=phase,
                wall_s=float(wall_s),
                counters={k: float(v) for k, v in counters.items()},
            )
        )

    def finish(self, total_s: float) -> None:
        self.total_s = float(total_s)

    # ---- queries --------------------------------------------------------

    def phase(self, name: str) -> PhaseStats:
        for p in self.phases:
            if p.phase == name:
                return p
        raise KeyError(
            f"no phase {name!r} in trace; recorded: "
            f"{[p.phase for p in self.phases]}"
        )

    def phase_names(self) -> list[str]:
        return [p.phase for p in self.phases]

    def phase_times(self) -> dict[str, float]:
        """Wall seconds per phase name.

        A phase name may appear several times — an elastically preempted
        job records one entry per executed *segment* (e.g. the map waves
        run before and after a regrant).  Times sum per name, so segmented
        and uninterrupted traces answer this query identically.
        """
        out: dict[str, float] = {}
        for p in self.phases:
            out[p.phase] = out.get(p.phase, 0.0) + p.wall_s
        return out

    def phase_time_sum(self) -> float:
        return sum(p.wall_s for p in self.phases)

    def counter(self, phase: str, name: str, default: float = 0.0) -> float:
        """Counter total for ``phase`` — summed across segment entries of
        the same phase (single-entry traces are unaffected); ``default``
        only when no entry of the phase carries the counter."""
        entries = [p for p in self.phases if p.phase == phase]
        if not entries:
            raise KeyError(
                f"no phase {phase!r} in trace; recorded: "
                f"{self.phase_names()}"
            )
        vals = [p.counters[name] for p in entries if name in p.counters]
        return sum(vals) if vals else default

    # ---- invariants ------------------------------------------------------

    def check_conservation(
        self, *, time_rel_tol: float = 0.5, time_abs_tol: float = 0.1
    ) -> list[str]:
        """Verify counter conservation laws; return violations (empty = ok).

        Byte/pair conservation is exact (counters are integers measured from
        the actual arrays).  The timing check is tolerant: per-phase fencing
        measures the same work as the outer total but adds host-side counter
        reads between phases, so the sum is compared within
        ``max(time_rel_tol * total, time_abs_tol)`` seconds.
        """
        bad: list[str] = []
        names = set(self.phase_names())
        # Counters aggregate across segment entries of the same phase
        # (elastic preemption splits phases into segments), so the same
        # laws hold for interrupted and uninterrupted runs.
        if "shuffle" in names:
            has = set().union(
                *(p.counters for p in self.phases if p.phase == "shuffle")
            )
            c = lambda name: self.counter("shuffle", name)
            if "bytes_in" in has and c("bytes_in") != c("bytes_out") + c(
                "bytes_dropped"
            ):
                bad.append(
                    "shuffle bytes_in != bytes_out + bytes_dropped "
                    f"({c('bytes_in')} != {c('bytes_out')} + "
                    f"{c('bytes_dropped')})"
                )
            if "pairs_in" in has and c("pairs_in") != c("pairs_out") + c(
                "pairs_dropped"
            ):
                bad.append("shuffle pairs_in != pairs_out + pairs_dropped")
            if "map" in names and "pairs_in" in has:
                emitted = self.counter("map", "pairs_emitted")
                # The shuffle consumes the map's emitted stream directly —
                # unless a combine stage sat between them, in which case
                # the shuffle consumes the combiner's (contracted) output.
                expect = emitted
                label = "map pairs_emitted"
                if "combine" in names:
                    expect = self.counter("combine", "pairs_out")
                    label = "combine pairs_out"
                if expect != c("pairs_in"):
                    bad.append(
                        f"{label} {expect} != shuffle pairs_in "
                        f"{c('pairs_in')}"
                    )
            if "net_bytes" in has and "pairs_in" in has:
                if c("net_bytes") != c("pairs_in") * PAIR_BYTES:
                    bad.append(
                        f"shuffle net_bytes {c('net_bytes')} != pairs_in "
                        f"{c('pairs_in')} * PAIR_BYTES {PAIR_BYTES}"
                    )
            if "net_s" in has and c("net_s") < 0:
                bad.append(f"shuffle net_s {c('net_s')} negative")
        if "combine" in names:
            has_c = set().union(
                *(p.counters for p in self.phases if p.phase == "combine")
            )
            cc = lambda name: self.counter("combine", name)
            if "map" in names and "pairs_in" in has_c:
                emitted = self.counter("map", "pairs_emitted")
                if emitted != cc("pairs_in"):
                    bad.append(
                        f"map pairs_emitted {emitted} != combine pairs_in "
                        f"{cc('pairs_in')}"
                    )
            # The combiner may only *contract* the stream (it merges
            # equal-key pairs, never invents new ones).
            if {"pairs_in", "pairs_out"} <= has_c and (
                cc("pairs_out") > cc("pairs_in")
            ):
                bad.append(
                    f"combine pairs_out {cc('pairs_out')} > pairs_in "
                    f"{cc('pairs_in')}"
                )
            if {"bytes_in", "bytes_out"} <= has_c and (
                cc("bytes_out") > cc("bytes_in")
            ):
                bad.append(
                    f"combine bytes_out {cc('bytes_out')} > bytes_in "
                    f"{cc('bytes_in')}"
                )
        # Only the shuffle phase moves bytes over the fabric; bookkeeping
        # phases (pipelined overlap credit, contention stalls) and compute
        # phases must record net_bytes as exactly zero if they record it.
        for p in self.phases:
            if p.phase != "shuffle" and p.counters.get("net_bytes", 0.0):
                bad.append(
                    f"{p.phase} net_bytes {p.counters['net_bytes']} != 0 "
                    "(only shuffle occupies the fabric)"
                )
        # CPU law: process CPU-seconds inside one fenced phase cannot
        # exceed wall x the parallelism ceiling recorded with the sample.
        # Negative-wall bookkeeping phases (pipelined overlap credit) are
        # exempt per phase and excluded from the aggregate.
        cpu_entries = [
            p for p in self.phases
            if "cpu_s" in p.counters and p.wall_s >= 0
        ]
        for p in cpu_entries:
            limit = p.counters.get("cpu_workers", 1.0)
            if p.counters["cpu_s"] > p.wall_s * limit + time_abs_tol:
                bad.append(
                    f"{p.phase} cpu_s {p.counters['cpu_s']:.4f} > wall "
                    f"{p.wall_s:.4f} * cpu_workers {limit:g}"
                )
        if cpu_entries:
            ceiling = max(
                p.counters.get("cpu_workers", 1.0) for p in cpu_entries
            )
            cpu_sum = sum(p.counters["cpu_s"] for p in cpu_entries)
            wall_sum = sum(p.wall_s for p in cpu_entries)
            if cpu_sum > wall_sum * ceiling + time_abs_tol:
                bad.append(
                    f"sum(cpu_s) {cpu_sum:.4f} > sum(wall) {wall_sum:.4f} "
                    f"* cpu_workers {ceiling:g}"
                )
        if self.total_s is not None and self.phases:
            gap = abs(self.total_s - self.phase_time_sum())
            if gap > max(time_rel_tol * self.total_s, time_abs_tol):
                bad.append(
                    f"phase times sum {self.phase_time_sum():.4f}s far from "
                    f"total {self.total_s:.4f}s"
                )
        return bad

    # ---- (de)serialization ----------------------------------------------

    def to_dict(self) -> dict:
        return {
            "schema": TRACE_SCHEMA_VERSION,
            "app": self.app,
            "config": dict(self.config),
            "total_s": self.total_s,
            "phases": [p.to_dict() for p in self.phases],
        }

    @staticmethod
    def from_dict(d: dict) -> "JobTrace":
        # Pre-schema dicts (the first trace format) carry no version
        # marker; they are shape-identical to version 1, so they load as
        # version 1.
        version = int(d.get("schema", 1))
        if not 1 <= version <= TRACE_SCHEMA_VERSION:
            raise ValueError(
                f"unsupported trace schema version {version}; this build "
                f"reads versions 1..{TRACE_SCHEMA_VERSION}"
            )
        return JobTrace(
            app=d["app"],
            config=dict(d["config"]),
            total_s=d.get("total_s"),
            phases=[
                PhaseStats(
                    phase=p["phase"],
                    wall_s=float(p["wall_s"]),
                    counters=dict(p["counters"]),
                )
                for p in d.get("phases", ())
            ],
        )

    def to_json(self, **dumps_kwargs) -> str:
        """Serialize (with the ``schema`` version field) to a JSON string."""
        dumps_kwargs.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(), **dumps_kwargs)

    @staticmethod
    def from_json(s: str) -> "JobTrace":
        d = json.loads(s)
        if not isinstance(d, dict):
            raise ValueError(
                f"serialized trace must be a JSON object, got "
                f"{type(d).__name__}"
            )
        return JobTrace.from_dict(d)


class PhaseRecorder:
    """Accumulates :class:`JobTrace` objects across job executions.

    The engine only uses the narrow protocol ``start_job(...) -> trace`` +
    ``trace.record_phase/finish`` (duck-typed, so the engine never imports
    this package).  Everything else here is analysis convenience.

    ``max_traces`` bounds retention (oldest dropped first) for long-lived
    recorders whose consumers only read recent traces — e.g. a traced
    cluster oracle executing thousands of profiling runs but handing only
    ``last`` to the scheduler.  ``None`` (default) keeps everything, which
    is what profiling harnesses that aggregate over all traces want.
    """

    def __init__(self, max_traces: int | None = None) -> None:
        if max_traces is not None and max_traces < 1:
            raise ValueError("max_traces must be >= 1")
        self.max_traces = max_traces
        self.traces: list[JobTrace] = []

    def __len__(self) -> int:
        return len(self.traces)

    @property
    def last(self) -> JobTrace:
        if not self.traces:
            raise IndexError("no traces recorded yet")
        return self.traces[-1]

    def start_job(self, app_name: str, cfg, input_len: int) -> JobTrace:
        config = dataclasses.asdict(cfg)
        config["input_len"] = int(input_len)
        return self.add(JobTrace(app=app_name, config=config))

    def add(self, trace: JobTrace) -> JobTrace:
        """Append ``trace`` (one started here, or one recorded in another
        process and read back with :meth:`JobTrace.from_json`), keeping
        ``max_traces``."""
        self.traces.append(trace)
        if self.max_traces is not None and len(self.traces) > self.max_traces:
            del self.traces[: len(self.traces) - self.max_traces]
        return trace

    def clear(self) -> None:
        self.traces.clear()

    def mean_phase_times(
        self, traces: Iterable[JobTrace] | None = None
    ) -> dict[str, float]:
        """Mean wall time per phase over ``traces`` (default: all)."""
        traces = list(self.traces if traces is None else traces)
        if not traces:
            return {}
        acc: dict[str, list[float]] = {}
        for t in traces:
            for p in t.phases:
                acc.setdefault(p.phase, []).append(p.wall_s)
        return {k: sum(v) / len(v) for k, v in acc.items()}


def collect_traced(trace: JobTrace, out_keys, out_vals) -> dict[int, int]:
    """Host-side collect phase, recorded into ``trace`` as phase 4.

    The engine's job output stops at the reduce partitions; gathering the
    (key -> value) dict is the collect phase, timed and counted here so a
    trace covers the full map → shuffle → reduce → collect pipeline.
    """
    from repro_torch.mapreduce.engine import collect_results

    t0 = time.perf_counter()
    c0 = time.process_time()
    result = collect_results(out_keys, out_vals)
    cpu = time.process_time() - c0
    wall = time.perf_counter() - t0
    trace.record_phase(
        "collect",
        wall,
        unique_keys=len(result),
        bytes_out=len(result) * PAIR_BYTES,
        cpu_s=cpu,
        cpu_workers=float(os.cpu_count() or 1),
    )
    if trace.total_s is not None:
        trace.finish(trace.total_s + wall)
    return result
