"""Analytic execution-time source: roofline terms from a dry run's counts;
counterpart of ``repro.core.costmodel``.

The reference turns a compiled XLA artifact into three roofline terms; the
port counts the same quantities while a step runs eagerly on a mesh of
fake ranks (``launch.cells``), all per device:

    compute    = flops / peak_flops              (s)
    memory     = bytes / hbm_bandwidth           (s)
    collective = collective_bytes / link_bandwidth (s)

``flops`` are the matrix products' (mm, bmm, attention, as
``torch.utils.flop_counter`` counts them) that one rank runs;
``collective_bytes`` sum the output operand of every collective DTensor
issues (``_c10d_functional`` all-gather, all-reduce, reduce-scatter,
all-to-all), under the reference's kind names.  ``bytes`` are unfused:
each aten op's inputs plus outputs.  XLA's "bytes accessed" counts after
fusion, so the memory term reads higher than the reference's.  The
estimated step time is max(compute, memory) + collective when overlap is
off, and max(compute, memory, collective) under perfect overlap; both
are reported.

This is also the analytic timer for the paper's profiling phase at scale:
time(config) := the estimated step time of the config's dry run.

The constants are one NVIDIA H100 SXM's, from its data sheet: dense bf16
peak, HBM3 bandwidth, 80 GB of HBM, and NVLink 4 at 450 GB/s per
direction per GPU.  ``ICI_BW`` stands for NVLink inside one 8-GPU node;
it does not model the InfiniBand links a 16x16 mesh crosses between
nodes, so the collective term of such a mesh reads low.
"""

from __future__ import annotations

import dataclasses
import math

PEAK_FLOPS_BF16 = 989e12       # FLOP/s per GPU, dense bf16
HBM_BW = 3.35e12               # bytes/s per GPU
ICI_BW = 450e9                 # bytes/s per GPU per direction, NVLink 4
HBM_BYTES = 80e9               # bytes per GPU

_COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)
#: ``_c10d_functional`` op name -> the reference's kind name
_FUNCTIONAL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


@dataclasses.dataclass
class CollectiveStats:
    """Per-kind byte totals of the collectives one device issues."""

    bytes_by_kind: dict[str, int]
    count_by_kind: dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


def collective_kind(op) -> str | None:
    """The reference's kind name of a ``_c10d_functional`` op, else None
    (``wait_tensor`` and every other op)."""
    if getattr(op, "namespace", None) != "_c10d_functional":
        return None
    return _FUNCTIONAL_KINDS.get(op._opname)


def parse_collectives(records) -> CollectiveStats:
    """Sum output-operand bytes by kind over ``records``, pairs of (a
    ``_c10d_functional`` op, its output's bytes); other ops are skipped."""
    bytes_by_kind: dict[str, int] = {k: 0 for k in _COLLECTIVE_KINDS}
    count_by_kind: dict[str, int] = {k: 0 for k in _COLLECTIVE_KINDS}
    for op, nbytes in records:
        kind = collective_kind(op)
        if kind is None:
            continue
        bytes_by_kind[kind] += int(nbytes)
        count_by_kind[kind] += 1
    return CollectiveStats(bytes_by_kind=bytes_by_kind, count_by_kind=count_by_kind)


@dataclasses.dataclass
class RooflineReport:
    """The roofline record for one (arch, shape, mesh) cell."""

    flops: float                  # per-device matrix-product flops
    hbm_bytes: float              # per-device unfused bytes (op inputs + outputs)
    collective_bytes: float       # per-device collective bytes (output sums)
    compute_s: float
    memory_s: float
    collective_s: float
    peak_hbm_bytes: float         # peak live bytes per device
    dominant: str
    # Usefulness accounting
    model_flops: float | None = None   # 6*N*D (train) / 2*N*D-style (serve), GLOBAL
    useful_ratio: float | None = None  # model_flops / (flops * n_devices)
    collectives: CollectiveStats | None = None

    @property
    def step_time_no_overlap(self) -> float:
        return max(self.compute_s, self.memory_s) + self.collective_s

    @property
    def step_time_overlap(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful model FLOP/s achieved ÷ peak, at the no-overlap step time.

        This is the score-bearing number: it charges every inefficiency
        (redundant compute, memory stalls, exposed collectives) against the
        machine's peak.
        """
        if not self.model_flops:
            return float("nan")
        return self.flops_fraction_of_peak

    @property
    def flops_fraction_of_peak(self) -> float:
        if not self.model_flops or self.n_devices is None:
            return float("nan")
        per_dev_useful = self.model_flops / self.n_devices
        t = self.step_time_no_overlap
        return (per_dev_useful / t) / PEAK_FLOPS_BF16 if t > 0 else float("nan")

    n_devices: int | None = None

    def to_dict(self) -> dict:
        d = {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "peak_hbm_bytes": self.peak_hbm_bytes,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "n_devices": self.n_devices,
            "step_time_no_overlap": self.step_time_no_overlap,
            "step_time_overlap": self.step_time_overlap,
            "roofline_fraction": self.flops_fraction_of_peak,
        }
        if self.collectives is not None:
            d["collective_bytes_by_kind"] = self.collectives.bytes_by_kind
            d["collective_count_by_kind"] = self.collectives.count_by_kind
        return d


def roofline_from_counts(
    flops: float,
    bytes: float,
    collectives: CollectiveStats,
    peak_bytes: float,
    n_devices: int,
    model_flops: float | None = None,
) -> RooflineReport:
    """The three roofline terms from one device's counts."""
    flops = float(flops)
    hbm_bytes = float(bytes)
    collective_bytes = float(collectives.total_bytes)
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = hbm_bytes / HBM_BW
    collective_s = collective_bytes / ICI_BW
    terms = {
        "compute": compute_s,
        "memory": memory_s,
        "collective": collective_s,
    }
    dominant = max(terms, key=terms.get)
    useful = None
    if model_flops is not None and flops > 0:
        useful = model_flops / (flops * n_devices)
    return RooflineReport(
        flops=flops,
        hbm_bytes=hbm_bytes,
        collective_bytes=collective_bytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        peak_hbm_bytes=float(peak_bytes),
        dominant=dominant,
        model_flops=model_flops,
        useful_ratio=useful,
        collectives=collectives,
        n_devices=n_devices,
    )


def format_seconds(s: float) -> str:
    if s == 0 or math.isnan(s):
        return f"{s:.3g}s"
    if s < 1e-3:
        return f"{s * 1e6:.1f}us"
    if s < 1:
        return f"{s * 1e3:.2f}ms"
    return f"{s:.3f}s"


__all__ = ["CollectiveStats", "HBM_BW", "HBM_BYTES", "ICI_BW", "PEAK_FLOPS_BF16",
           "RooflineReport", "collective_kind", "format_seconds", "parse_collectives",
           "roofline_from_counts"]
