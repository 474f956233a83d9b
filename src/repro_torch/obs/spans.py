"""Span tracing: the causal tree cluster-run → job → segment → wave/phase
(counterpart of ``repro.obs.spans``).

Nothing here instruments the hot path.  A completed
:class:`~repro_torch.cluster.cluster.TraceResult` already contains everything a
trace viewer needs — ``JobRecord.segments`` (elastic grant intervals),
``JobRecord.waves``/``gaps`` (wave boundaries and regrant/suspend holes,
recorded by the elastic sim as it consumes segments), and per-phase
:class:`~repro_torch.telemetry.JobTrace` walls — so :func:`build_span_tree`
assembles the tree post-hoc and :func:`to_chrome_trace` exports Chrome
trace-event JSON loadable in Perfetto / ``chrome://tracing``:

* pid 1, one thread per **worker slot** — job execution intervals placed
  onto concrete slots by a greedy interval assignment (the sim's worker
  conservation guarantees it fits), with wave/phase spans nested inside;
* pid 1 **counter tracks** for queue depth, busy workers, suspended jobs;
* pid 2, one thread per **job** — the causal per-job view: wait span,
  execution segments, regrant/suspended gaps, wave/phase children.

Conservation discipline (same as ``JobTrace.check_conservation``, but
exact): a job span's children — wait + segments + gaps — must tile its
turnaround, and a segment's wave/phase children must tile the segment.
:func:`check_span_tiling` verifies it; the only tolerance granted is float
associativity (sums of exact boundary differences), not modeling slack.
The pipelined mode's negative-wall ``pipeline`` phase participates in the
sums *signed* — overlap is negative exposure — and exports as an instant
event (Chrome ``dur`` must be >= 0).
"""

from __future__ import annotations

import dataclasses
import heapq
import json

__all__ = [
    "Span",
    "SpanRecorder",
    "build_span_tree",
    "check_span_tiling",
    "render_slots",
    "to_chrome_trace",
    "validate_chrome_trace",
]


@dataclasses.dataclass
class Span:
    """One node of the causal tree: a named interval with children.

    ``wall_s`` is *signed*: the pipelined mode's overlap phase contributes
    negative exposure so sibling walls still sum to the parent's wall.
    """

    name: str
    cat: str                  # "run" | "job" | "wait" | "segment" | "gap"
    t0: float                 #      | "wave" | "phase"
    wall_s: float
    args: dict = dataclasses.field(default_factory=dict)
    children: list = dataclasses.field(default_factory=list)

    @property
    def t1(self) -> float:
        return self.t0 + self.wall_s

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


# --------------------------------------------------------------- assembly


def _phase_children(trace, t0: float) -> list[Span]:
    """Phase spans laid end-to-end from ``t0`` (base-cluster jobs run one
    uninterrupted segment, so sequential placement is exact)."""
    out = []
    cur = t0
    for p in trace.phases:
        out.append(
            Span(name=p.phase, cat="phase", t0=cur, wall_s=p.wall_s,
                 args=dict(p.counters))
        )
        cur += p.wall_s
    return out


def _job_span(rec) -> Span | None:
    spec = rec.spec
    if not rec.completed:
        return None
    job = Span(
        name=f"job {spec.job_id}", cat="job", t0=spec.arrival,
        wall_s=rec.finish - spec.arrival,
        args={
            "job_id": spec.job_id, "app": spec.app, "size": spec.size,
            "backend": rec.plan.backend, "workers": rec.plan.workers,
            "depth": rec.plan.depth, "n_regrants": rec.n_regrants,
            "n_suspends": rec.n_suspends,
        },
    )
    job.children.append(
        Span(name="wait", cat="wait", t0=spec.arrival,
             wall_s=rec.start - spec.arrival)
    )
    if rec.segments:
        waves = list(getattr(rec, "waves", None) or ())
        for idx, (ts, t1, w) in enumerate(rec.segments):
            seg = Span(
                name=f"segment {idx}", cat="segment", t0=ts, wall_s=t1 - ts,
                args={"workers": w},
            )
            seg.children = [
                Span(name=kind, cat="wave", t0=wt0, wall_s=wt1 - wt0,
                     args={"workers": ww})
                for wt0, wt1, kind, ww in waves
                if ts - 1e-12 <= wt0 and wt1 <= t1 + 1e-12
            ]
            job.children.append(seg)
        for gt0, gt1, kind, held in getattr(rec, "gaps", None) or ():
            job.children.append(
                Span(name=kind, cat="gap", t0=gt0, wall_s=gt1 - gt0,
                     args={"workers_held": held})
            )
    else:
        seg = Span(
            name="segment 0", cat="segment", t0=rec.start,
            wall_s=rec.finish - rec.start,
            args={"workers": rec.plan.workers},
        )
        trace = rec.trace
        if trace is not None and getattr(trace, "phases", None):
            seg.children = _phase_children(trace, rec.start)
        job.children.append(seg)
    return job


def build_span_tree(result) -> Span:
    """Assemble the causal tree for one completed cluster run."""
    records = result.records
    done = [r for r in records if r.completed]
    if not done:
        raise ValueError(
            f"result for policy {result.policy!r} has no completed jobs"
        )
    t0 = min(r.spec.arrival for r in records)
    t_end = max(r.finish for r in done)
    root = Span(
        name=f"cluster-run {result.policy}", cat="run", t0=t0,
        wall_s=t_end - t0,
        args={
            "policy": result.policy,
            "total_workers": result.total_workers,
            "n_jobs": len(records),
            "n_completed": len(done),
        },
    )
    root.children = [s for r in done if (s := _job_span(r)) is not None]
    return root


# ------------------------------------------------------------ conservation


def check_span_tiling(
    root: Span, *, rel_tol: float = 1e-6, abs_tol: float = 1e-9
) -> list[str]:
    """Verify the tiling discipline; return violations (empty = healthy).

    * every job span's children (wait + segments + gaps) sum to its
      turnaround;
    * every segment span with children has them summing to its wall;
    * children lie inside their parent's interval — except under a
      negative-wall sibling (pipelined overlap): phases that physically
      overlap are laid out sequentially, so their notional placement may
      poke past the parent while their *signed sum* stays exact.  The sum
      check never relaxes.

    The tolerance covers float associativity only — these are sums of
    exact event-time differences, not modeled quantities.
    """
    bad: list[str] = []

    def tol(x: float) -> float:
        return max(rel_tol * abs(x), abs_tol)

    for span in root.walk():
        if span.cat not in ("job", "segment") or not span.children:
            continue
        total = sum(c.wall_s for c in span.children)
        if abs(total - span.wall_s) > tol(span.wall_s):
            bad.append(
                f"{span.name}: children sum {total:.9f}s != "
                f"wall {span.wall_s:.9f}s"
            )
        overlapped = any(c.wall_s < 0 for c in span.children)
        for c in span.children:
            if not overlapped and c.wall_s >= 0 and (
                c.t0 < span.t0 - tol(span.wall_s)
                or c.t1 > span.t1 + tol(span.wall_s)
            ):
                bad.append(
                    f"{span.name}: child {c.name} "
                    f"[{c.t0:.6f}, {c.t1:.6f}] outside "
                    f"[{span.t0:.6f}, {span.t1:.6f}]"
                )
    return bad


# ------------------------------------------------------------ worker slots


def _hold_intervals(rec) -> list[tuple[float, float, int, str]]:
    """(t0, t1, workers, label) intervals during which ``rec`` holds
    worker slots — execution segments plus the overhead gaps that keep
    their grant (suspended gaps hold zero and are excluded)."""
    out = []
    if rec.segments:
        for ts, t1, w in rec.segments:
            out.append((ts, t1, int(w), "run"))
        for gt0, gt1, kind, held in getattr(rec, "gaps", None) or ():
            if held:
                out.append((gt0, gt1, int(held), kind))
    else:
        out.append((rec.start, rec.finish, int(rec.plan.workers), "run"))
    return sorted(out)


def _assign_slots(intervals, total_workers: int) -> list[list[int]]:
    """Greedy interval-partitioning onto worker slots.  ``intervals`` is
    [(t0, t1, w, job_id, label), ...]; returns the slot list per interval
    (parallel to the input).  The sim's conservation invariant guarantees
    at most ``total_workers`` are held at any instant, so this never
    runs out when intervals ending at t are released before those
    starting at t acquire."""
    order = sorted(
        range(len(intervals)), key=lambda i: (intervals[i][0], intervals[i][3])
    )
    free = list(range(total_workers))
    heapq.heapify(free)
    busy: list[tuple[float, int, list[int]]] = []  # (t1, tiebreak, slots)
    out: list[list[int]] = [[] for _ in intervals]
    for idx in order:
        t0, t1, w, job_id, _ = intervals[idx]
        while busy and busy[0][0] <= t0 + 1e-12:
            _, _, slots = heapq.heappop(busy)
            for s in slots:
                heapq.heappush(free, s)
        if w > len(free):
            raise AssertionError(
                f"slot assignment needs {w} slots for job {job_id} at "
                f"t={t0:.6f} but only {len(free)} are free — worker "
                "conservation violated upstream"
            )
        slots = [heapq.heappop(free) for _ in range(w)]
        out[idx] = slots
        heapq.heappush(busy, (t1, idx, slots))
    return out


# ------------------------------------------------------------ chrome export

_US = 1e6   # trace-event timestamps are microseconds


def _ev(name, ph, ts, pid, tid, **kw) -> dict:
    ev = {"name": name, "ph": ph, "ts": round(ts * _US, 3),
          "pid": pid, "tid": tid}
    ev.update(kw)
    return ev


def _emit_span(events, span: Span, pid: int, tid: int, cat: str) -> None:
    if span.wall_s < 0:
        # Negative exposure (pipeline overlap) cannot be a Chrome complete
        # event; export as an instant carrying the signed wall.
        events.append(_ev(
            span.name, "i", span.t0, pid, tid, s="t",
            args={**span.args, "wall_s": span.wall_s},
        ))
        return
    events.append(_ev(
        span.name, "X", span.t0, pid, tid,
        dur=round(span.wall_s * _US, 3), cat=cat, args=dict(span.args),
    ))


def _counter_events(result, holds) -> list[dict]:
    """Cumulative "C" events for queue depth / busy workers / suspended."""
    deltas: dict[str, list[tuple[float, float]]] = {
        "queue_depth": [], "busy_workers": [], "suspended_jobs": [],
    }
    for rec in result.records:
        deltas["queue_depth"].append((rec.spec.arrival, +1))
        if rec.start is not None:
            deltas["queue_depth"].append((rec.start, -1))
        elif not rec.admitted and getattr(rec, "reject_time", None) is not None:
            deltas["queue_depth"].append((rec.reject_time, -1))
        for gt0, gt1, kind, _held in getattr(rec, "gaps", None) or ():
            if kind == "suspended":
                deltas["suspended_jobs"].append((gt0, +1))
                deltas["suspended_jobs"].append((gt1, -1))
    for t0, t1, w, _job_id, _label in holds:
        deltas["busy_workers"].append((t0, +w))
        deltas["busy_workers"].append((t1, -w))
    events = []
    for name, dd in deltas.items():
        level = 0.0
        # Sort by time with decrements first so instantaneous handoffs
        # don't spike the counter above its true level.
        for t, d in sorted(dd, key=lambda x: (x[0], x[1])):
            level += d
            events.append(_ev(
                name, "C", t, 1, 0, args={"value": round(level, 6)}
            ))
    return events


def _control_events(control_log) -> list[dict]:
    """pid 3 "slo control": one instant event per audited control action
    (trip/clear/shed/suspend/resume) plus burn-rate counter tracks, so the
    overload-control storyline reads directly under the worker timeline."""
    events = [
        _ev("process_name", "M", 0, 3, 0, args={"name": "slo control"}),
        _ev("thread_name", "M", 0, 3, 0, args={"name": "decisions"}),
    ]
    for a in control_log:
        name = (a.action if a.job_id is None
                else f"{a.action} job {a.job_id}")
        events.append(_ev(
            name, "i", a.t, 3, 0, s="t",
            args={
                "action": a.action, "job_id": a.job_id,
                "reason": a.reason,
                "burn_fast": round(a.burn_fast, 6),
                "burn_slow": round(a.burn_slow, 6),
            },
        ))
        for track, value in (
            ("slo_burn_fast", a.burn_fast), ("slo_burn_slow", a.burn_slow),
        ):
            events.append(_ev(
                track, "C", a.t, 3, 0, args={"value": round(value, 6)}
            ))
    return events


def to_chrome_trace(result, *, counters: bool = True, control_log=None,
                    resources=None) -> dict:
    """Export one run as Chrome trace-event JSON (Perfetto-loadable).

    ``control_log`` (a list of :class:`~repro_torch.obs.controller.
    ControlAction`) adds the pid 3 "slo control" tracks.  ``resources``
    (a :class:`~repro_torch.obs.resources.ResourceTimeline`, built from the
    result when omitted) adds the pid 4 "cluster resources" counter
    tracks — fabric bytes/s vs capacity and busy CPU — whenever the
    run's traces carry resource counters."""
    root = build_span_tree(result)
    events: list[dict] = [
        _ev("process_name", "M", 0, 1, 0,
            args={"name": "worker slots"}),
        _ev("process_name", "M", 0, 2, 0, args={"name": "jobs"}),
    ]
    for slot in range(result.total_workers):
        events.append(_ev(
            "thread_name", "M", 0, 1, slot,
            args={"name": f"worker {slot}"},
        ))

    # -- pid 1: worker-slot tracks ------------------------------------
    done = [r for r in result.records if r.completed]
    flat: list[tuple[float, float, int, int, str]] = []
    per_rec: dict[int, list[int]] = {}   # job_id -> indices into flat
    for rec in done:
        for t0, t1, w, label in _hold_intervals(rec):
            per_rec.setdefault(rec.spec.job_id, []).append(len(flat))
            flat.append((t0, t1, w, rec.spec.job_id, label))
    slot_lists = _assign_slots(flat, result.total_workers)
    job_spans = {s.args["job_id"]: s for s in root.children}
    for idx, (t0, t1, w, job_id, label) in enumerate(flat):
        name = (f"job {job_id}" if label == "run"
                else f"job {job_id} [{label}]")
        for slot in slot_lists[idx]:
            events.append(_ev(
                name, "X", t0, 1, slot, dur=round((t1 - t0) * _US, 3),
                cat="slot" if label == "run" else "overhead",
                args={"job_id": job_id, "workers": w, "kind": label},
            ))
        if label == "run":
            # Nest wave/phase children on the interval's first slot.
            jspan = job_spans.get(job_id)
            if jspan is not None and slot_lists[idx]:
                tid = slot_lists[idx][0]
                for seg in jspan.children:
                    if seg.cat != "segment" or not (
                        t0 - 1e-12 <= seg.t0 and seg.t1 <= t1 + 1e-12
                    ):
                        continue
                    for child in seg.children:
                        _emit_span(events, child, 1, tid, child.cat)

    # -- pid 2: per-job causal tracks ---------------------------------
    for jspan in root.children:
        job_id = jspan.args["job_id"]
        events.append(_ev(
            "thread_name", "M", 0, 2, job_id,
            args={"name": f"job {job_id}"},
        ))
        _emit_span(events, jspan, 2, job_id, "job")
        for child in jspan.children:
            _emit_span(events, child, 2, job_id, child.cat)
            for grand in child.children:
                _emit_span(events, grand, 2, job_id, grand.cat)
    for rec in result.records:
        if rec.admitted or getattr(rec, "reject_time", None) is None:
            continue
        events.append(_ev(
            f"reject job {rec.spec.job_id}", "i", rec.reject_time, 2,
            rec.spec.job_id, s="t",
            args={"reason": rec.reject_reason},
        ))

    if counters:
        events += _counter_events(result, flat)
        if resources is None:
            from repro_torch.obs.resources import ResourceTimeline

            resources = ResourceTimeline.from_result(result)
        if resources.has_data:
            events += resources.counter_events()
    if control_log:
        events += _control_events(control_log)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "policy": result.policy,
            "total_workers": result.total_workers,
        },
    }


def validate_chrome_trace(doc) -> list[str]:
    """Well-formedness check on an exported trace; [] = valid."""
    bad: list[str] = []
    if not isinstance(doc, dict) or not isinstance(
        doc.get("traceEvents"), list
    ):
        return ["top level must be a dict with a traceEvents list"]
    for i, ev in enumerate(doc["traceEvents"]):
        where = f"event {i}"
        if not isinstance(ev, dict):
            bad.append(f"{where}: not a dict")
            continue
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                bad.append(f"{where}: missing {field!r}")
        ph = ev.get("ph")
        if ph not in ("X", "C", "M", "i"):
            bad.append(f"{where}: unknown phase {ph!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                bad.append(f"{where}: X event needs dur >= 0, got {dur!r}")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not all(
                isinstance(v, (int, float)) for v in args.values()
            ):
                bad.append(f"{where}: C event needs numeric args")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            bad.append(f"{where}: non-numeric ts {ts!r}")
    return bad


# ------------------------------------------------------------- text render

_SYMBOLS = "0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def render_slots(result, width: int = 64) -> str:
    """Perfetto-screenshot-equivalent text view: one row per worker slot,
    one column per time bucket; job symbols fill execution intervals,
    ``~`` marks regrant/restore overhead, ``.`` is idle."""
    done = [r for r in result.records if r.completed]
    if not done:
        return "(no completed jobs)"
    t0 = min(r.spec.arrival for r in result.records)
    t_end = max(r.finish for r in done)
    span = max(t_end - t0, 1e-9)
    flat: list[tuple[float, float, int, int, str]] = []
    for rec in done:
        for a, b, w, label in _hold_intervals(rec):
            flat.append((a, b, w, rec.spec.job_id, label))
    slot_lists = _assign_slots(flat, result.total_workers)
    grid = [["."] * width for _ in range(result.total_workers)]
    symbol = {
        r.spec.job_id: _SYMBOLS[i % len(_SYMBOLS)]
        for i, r in enumerate(sorted(done, key=lambda r: r.spec.job_id))
    }
    for idx, (a, b, _w, job_id, label) in enumerate(flat):
        c0 = int((a - t0) / span * width)
        c1 = max(c0 + 1, int((b - t0) / span * width))
        ch = symbol[job_id] if label == "run" else "~"
        for slot in slot_lists[idx]:
            for c in range(c0, min(c1, width)):
                grid[slot][c] = ch
    lines = [
        f"t=[{t0:.2f}s, {t_end:.2f}s]  one column ≈ {span / width:.3f}s  "
        "(~ = regrant/restore overhead, . = idle)"
    ]
    lines += [
        f"slot {slot:>2} |{''.join(row)}|" for slot, row in enumerate(grid)
    ]
    legend = "  ".join(
        f"{symbol[j]}=job{j}" for j in sorted(symbol)[:16]
    )
    lines.append(f"jobs: {legend}" + (" …" if len(symbol) > 16 else ""))
    return "\n".join(lines)


# --------------------------------------------------------------- recorder


class SpanRecorder:
    """Assembles and retains span trees for completed cluster runs.

    The recorder is pull-based: nothing registers callbacks into the sims
    (hot paths stay untouched); call :meth:`record` with a finished
    :class:`TraceResult` and the causal tree is built from the records.

    ``max_jobs`` bounds retention for service-mode runs whose streams are
    open-ended: only the *last* ``max_jobs`` completed jobs (by finish
    time) enter the tree — a ring over the completion stream — and
    everything older is dropped on arrival, tallied in
    ``n_dropped_jobs`` / ``n_dropped_spans`` so truncation is visible, not
    silent.  Tiling (:meth:`check`) then holds on the retained window.
    ``record(..., control_log=…)`` attaches an overload-control audit log
    that :meth:`chrome` renders as the "slo control" tracks.
    """

    def __init__(self, max_jobs: int | None = None):
        if max_jobs is not None and max_jobs < 1:
            raise ValueError(f"max_jobs must be >= 1, got {max_jobs}")
        self.max_jobs = max_jobs
        self.n_dropped_jobs = 0
        self.n_dropped_spans = 0
        self._runs: list[tuple[object, Span, object]] = []

    def __len__(self) -> int:
        return len(self._runs)

    def _prune(self, result):
        """Retain the last ``max_jobs`` completed jobs (plus any
        not-completed records inside the retained arrival window)."""
        done = sorted(
            (r for r in result.records if r.completed),
            key=lambda r: (r.finish, r.spec.job_id),
        )
        kept = {r.spec.job_id for r in done[-self.max_jobs:]}
        if len(kept) == len(result.records):
            return result
        cutoff = min(
            (r.spec.arrival for r in done[-self.max_jobs:]),
            default=float("-inf"),
        )
        records = []
        for r in result.records:
            if (r.spec.job_id in kept
                    or (not r.completed and r.spec.arrival >= cutoff)):
                records.append(r)
                continue
            self.n_dropped_jobs += 1
            if r.completed:
                span = _job_span(r)
                self.n_dropped_spans += sum(1 for _ in span.walk())
        if len(records) == len(result.records):
            return result
        return dataclasses.replace(result, records=records)

    def record(self, result, control_log=None) -> Span:
        if self.max_jobs is not None:
            result = self._prune(result)
        root = build_span_tree(result)
        self._runs.append((result, root, control_log))
        return root

    @property
    def roots(self) -> list[Span]:
        return [root for _, root, _ in self._runs]

    def check(self, **tol) -> list[str]:
        """Tiling violations across every recorded run ([] = healthy)."""
        bad: list[str] = []
        for result, root, _ in self._runs:
            bad += [
                f"{result.policy}: {v}" for v in check_span_tiling(root, **tol)
            ]
        return bad

    def chrome(self, index: int = -1, **kw) -> dict:
        result, _, control_log = self._runs[index]
        kw.setdefault("control_log", control_log)
        return to_chrome_trace(result, **kw)

    def validate(self, index: int = -1, **kw) -> list[str]:
        """Well-formedness issues of the exported doc ([] = valid)."""
        return validate_chrome_trace(self.chrome(index, **kw))

    def save_chrome(self, path: str, index: int = -1, **kw) -> dict:
        doc = self.chrome(index, **kw)
        with open(path, "w") as fp:
            json.dump(doc, fp)
        return doc
