"""What the program's own ``record_function`` spans say about a
``torch.profiler`` profile of fused jobs (``profiling.traced``).

The program opens its spans (``repro_torch.mapreduce.spans``) only while a
profiler records: a job, its phases, each wave, and each step of the
shuffle.  :func:`records` turns a profile into record keys; :func:`read`
gives each per-layer metric from them, or None where the program opened
no such span (a program without spans gives None everywhere).  The names
are written out here, not imported, so that this module runs against any
version of the program.

    span_n         instances of each span in the profile
    span_s         device seconds of the operations launched inside each
                   span (at any depth), summed over its instances
    span_jobs      ``mapreduce.job`` spans: the jobs profiled
    launches       device operations (kernels, copies, fills) launched
                   from inside ``mapreduce.job`` spans
    device_op_s    device seconds of every operation of the profile
    idle_in_job_s  device-idle seconds that overlap a host
                   ``mapreduce.job`` span, on the profiler's clock
"""

from __future__ import annotations

from torch.autograd import DeviceType

from portbench.profiling import HOST_PYTHON, _device_events, _union

JOB = "mapreduce.job"
#: the profiler's own host event, listed beside a launch it interrupted
BUFFER_REQUEST = "Activity Buffer Request"
#: the program's span names (``repro_torch.mapreduce.spans.SPANS``)
SPANS = (
    JOB,
    "mapreduce.map",
    "mapreduce.map.wave",
    "mapreduce.map.spill_sort",
    "mapreduce.combine",
    "mapreduce.shuffle",
    "mapreduce.shuffle.sort",
    "mapreduce.shuffle.gather",
    "mapreduce.shuffle.scatter",
    "mapreduce.shuffle.pack",
    "mapreduce.shuffle.exchange",
    "mapreduce.shuffle.unpack",
    "mapreduce.reduce",
    "mapreduce.reduce.wave",
    "mapreduce.gather",
)
#: metrics of device ms a job, and the span each reads
DEVICE_MS = {
    "map.device_ms": "mapreduce.map",
    "combine.device_ms": "mapreduce.combine",
    "shuffle.device_ms": "mapreduce.shuffle",
    "reduce.device_ms": "mapreduce.reduce",
    "map.spill_sort_ms": "mapreduce.map.spill_sort",
    "shuffle.sort_ms": "mapreduce.shuffle.sort",
    "shuffle.gather_ms": "mapreduce.shuffle.gather",
    "shuffle.scatter_ms": "mapreduce.shuffle.scatter",
}
METRICS = (*DEVICE_MS, "plan.launches", "device.idle_in_job_pct")


def _host_spans(events):
    return [e for e in events if e.device_type == DeviceType.CPU and e.name in SPANS]


def _overlap(a, b, merged) -> float:
    """Length of [a, b] covered by the sorted disjoint intervals ``merged``."""
    return sum(max(0, min(b, e) - max(a, s)) for s, e in merged if s < b and e > a)


def launches_by_span(events) -> list:
    """(spans around it, innermost first, and its device operations) for
    each host operation that launched any.  The profiler lists a launch
    made while it fetched a trace buffer twice, under the operation and
    under an ``Activity Buffer Request`` of the same id: each counts once."""
    out, seen = [], set()
    for e in events:
        if (e.device_type != DeviceType.CPU or not e.kernels or e.id in seen
                or e.name == BUFFER_REQUEST):
            continue
        seen.add(e.id)
        above, p = [], e
        while p is not None:
            if p.name in SPANS:
                above.append(p.name)
            p = p.cpu_parent
        out.append((above, e.kernels))
    return out


def records(box) -> dict:
    """The record keys of one profiled block (see the module's doc)."""
    events = box["prof"].events()
    spans = _host_spans(events)
    jobs = [e for e in spans if e.name == JOB]
    span_us = dict.fromkeys(SPANS, 0.0)
    launched = 0
    for above, kernels in launches_by_span(events):
        for name in set(above):
            span_us[name] += sum(k.duration for k in kernels)
        launched += len(kernels) if JOB in above else 0
    dev = _device_events(events)
    busy = _union((e.time_range.start, e.time_range.end) for e in dev)
    idle_us = sum(e.time_range.end - e.time_range.start
                  - _overlap(e.time_range.start, e.time_range.end, busy)
                  for e in jobs)
    return {
        "span_n": {n: sum(e.name == n for e in spans) for n in SPANS},
        "span_s": {n: us / 1e6 for n, us in span_us.items()},
        "span_jobs": len(jobs),
        "launches": launched,
        "device_op_s": sum(e.time_range.elapsed_us() for e in dev) / 1e6,
        "idle_in_job_s": idle_us / 1e6,
    }


def device_ms(records: dict, span: str):
    """Device ms a job of the operations launched inside ``span``."""
    jobs = records.get("span_jobs")
    if not jobs or not records.get("span_n", {}).get(span):
        return None
    return 1e3 * records["span_s"][span] / jobs


def launches(records: dict):
    """Device operations launched inside a job, per job."""
    jobs = records.get("span_jobs")
    return records["launches"] / jobs if jobs else None


def idle_in_job_pct(records: dict):
    """Device-idle time inside host job spans, % of the profiled window."""
    window = records.get("window_s")
    if not records.get("span_jobs") or not window:
        return None
    return 100.0 * records["idle_in_job_s"] / window


def read(metric: str, records: dict):
    """One of :data:`METRICS` from a traced run's records."""
    if metric in DEVICE_MS:
        return device_ms(records, DEVICE_MS[metric])
    if metric == "plan.launches":
        return launches(records)
    if metric == "device.idle_in_job_pct":
        return idle_in_job_pct(records)
    raise KeyError(metric)


def longest_gaps(events, top: int = 10) -> list:
    """The ``top`` longest device-idle gaps between device operations, as
    (length, start, end) on the profiler's clock, longest first."""
    merged = _union((e.time_range.start, e.time_range.end)
                    for e in _device_events(events))
    return sorted(((b - a, a, b) for (_, a), (b, _) in zip(merged, merged[1:])),
                  reverse=True)[:top]


def idle_gaps(box, top: int = 10) -> list:
    """The longest device-idle gaps of a profiled block: [innermost program
    span at the gap's middle (``HOST_PYTHON`` outside every span), innermost
    host event there, seconds]."""
    events = box["prof"].events()
    host = [e for e in events if e.device_type == DeviceType.CPU
            and not e.is_async and e.time_range.end > e.time_range.start]
    spans = _host_spans(events)
    out = []
    for length, a, b in longest_gaps(events, top):
        mid = (a + b) / 2

        def innermost(pool):
            inner = [e for e in pool if e.time_range.start <= mid <= e.time_range.end]
            return max(inner, key=lambda e: e.time_range.start).name if inner else HOST_PYTHON

        out.append([innermost(spans), innermost(host), length / 1e6])
    return out
