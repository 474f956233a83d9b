"""What a ``torch.profiler`` trace of some jobs says: the device's busy
time, its longest idle gaps named by what the host was doing, device time
by operation, and the device time of the operations launched inside a
``record_function`` range."""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import DeviceType

#: the name of a gap in which no host operation was running
HOST_PYTHON = "host: python"
TOP = 10


@contextlib.contextmanager
def traced(device):
    """Profile the block on ``device``; yields a dict that holds, once the
    block is left, the profile (``prof``) and the block's host seconds
    (``window_s``), which ends in a synchronisation."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    box = {}
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        yield box
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        box["window_s"] = time.perf_counter() - t0
    box["prof"] = prof


def _device_events(events):
    return [e for e in events
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summary(box) -> dict:
    """busy_s, window_s and the breakdown of one profiled block."""
    events = box["prof"].events()
    dev = _device_events(events)
    merged = _union((e.time_range.start, e.time_range.end) for e in dev)
    busy_s = sum(e - s for s, e in merged) / 1e6
    by_op: dict[str, float] = {}
    for e in dev:
        by_op[e.name] = by_op.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    gaps = sorted(((b - a, a, b) for (_, a), (b, _) in zip(merged, merged[1:])),
                  reverse=True)[:TOP]
    host = [e for e in events if e.device_type == DeviceType.CPU
            and not e.is_async and e.time_range.end > e.time_range.start]
    idle = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        inner = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        name = max(inner, key=lambda e: e.time_range.start).name if inner else HOST_PYTHON
        idle.append([name, length / 1e6])
    return {
        "busy_s": busy_s,
        "window_s": box["window_s"],
        "device_ops": sorted(([k[:160], v] for k, v in by_op.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": idle,
    }


def range_device_s(box, names) -> dict:
    """Seconds of device time of the operations launched inside each
    ``record_function`` range of ``names``, summed over its instances."""
    out = {n: 0.0 for n in names}
    for e in box["prof"].events():
        if e.name in out and e.device_type == DeviceType.CPU:
            out[e.name] += e.device_time_total / 1e6
    return out
