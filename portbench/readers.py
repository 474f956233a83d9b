"""What the per-layer metric readers share.

A reader (``portbench/metrics/<metric>.py``) is a function ``read(records)``
over a traced run's records, which ``harness.trace_extras`` makes: ``enqueue_s`` (each window job's call-to-return seconds),
``traces`` (the traced mode's ``JobTrace`` dicts), ``range_s`` (device
seconds inside each ``record_function`` range of the phase runs, over the
same jobs as ``traces``), ``bytes_per_s`` (the card's published memory
bandwidth, or None), ``busy_s`` and ``window_s`` (the profiled fused
jobs).  A reader that finds nothing to read returns None.
"""

from __future__ import annotations

#: bytes of one (key, value) pair: two int32s
PAIR_BYTES = 8


def counter(trace: dict, phase: str, name: str) -> float:
    return sum(p["counters"].get(name, 0.0) for p in trace["phases"]
               if p["phase"] == phase)


def phase_ms(records: dict, phase: str):
    """The mean wall of one phase over the traced jobs, ms."""
    walls = [p["wall_s"] for t in records.get("traces", ()) for p in t["phases"]
             if p["phase"] == phase]
    return 1e3 * sum(walls) / len(walls) if walls else None


def roofline_pct(records: dict, phase: str, pairs) -> float | None:
    """The phase's share of its memory roofline, %: the pairs it must read
    and write, ``pairs(trace)`` a job, at the card's published bandwidth,
    over the device time of the operations launched in its range."""
    seconds = records.get("range_s", {}).get(f"portbench.{phase}")
    bandwidth = records.get("bytes_per_s")
    traces = [t for t in records.get("traces", ()) if
              any(p["phase"] == phase for p in t["phases"])]
    if not seconds or not bandwidth or not traces:
        return None
    moved = sum(pairs(t) for t in traces) * PAIR_BYTES
    return 100.0 * moved / bandwidth / seconds

