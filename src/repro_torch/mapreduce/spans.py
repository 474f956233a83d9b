"""Named ranges inside the engine's jobs, on the profiler's clock.

:func:`span` opens a ``torch.profiler.record_function`` range while a
``torch.profiler`` is recording and a shared do-nothing context otherwise,
so a job run without a profiler enters no range at all.  The gate is read
at every call, not when a plan is built: a job built before the profiler
starts has its ranges while the profiler records.  The ranges sit in the
profiler's timeline beside the device operations launched inside them, so
a profile says which phase, wave or shuffle step each operation and each
idle gap of the device belongs to.

The names (:data:`SPANS`), and where each range lies:

==============================  ============================================
``mapreduce.job``               one job (fused, pipelined, traced), or one
                                rank's part of a sharded job; args ``app``,
                                ``M``, ``R``, ``W``
``mapreduce.map``               the map phase
``mapreduce.map.wave``          one map wave (a wave group when pipelined);
                                args: the wave's index
``mapreduce.map.spill_sort``    a wave's stable spill sort and its gathers
``mapreduce.combine``           the map-side combine barrier
``mapreduce.shuffle``           the shuffle barrier
``mapreduce.shuffle.sort``      lexsort, plain version: hash, pack, stable
                                (reducer, key) sort
``mapreduce.shuffle.gather``    lexsort, plain version: keys, values,
                                reducer ids in order
``mapreduce.shuffle.scatter``   lexsort, plain version: the
                                capacity-bounded scatter
``mapreduce.shuffle.split``     lexsort on the card: count, scan, plan and
                                the split of each row by reducer
``mapreduce.shuffle.merge``     lexsort on the card: the merge rounds into
                                the partitions and their tails
``mapreduce.shuffle.pack``      all-to-all: partition by destination worker
``mapreduce.shuffle.exchange``  all-to-all: the live width and the exchange
                                (``all_to_all_single``, or the block
                                transpose that stands for it on one device)
``mapreduce.shuffle.unpack``    all-to-all: received pairs into reduce slots
``mapreduce.reduce``            the reduce phase
``mapreduce.reduce.wave``       one reduce wave or wave group; args: index
``mapreduce.gather``            sharded: the output all-gather to every rank
==============================  ============================================
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["SPANS", "span"]

SPANS = (
    "mapreduce.job",
    "mapreduce.map",
    "mapreduce.map.wave",
    "mapreduce.map.spill_sort",
    "mapreduce.combine",
    "mapreduce.shuffle",
    "mapreduce.shuffle.sort",
    "mapreduce.shuffle.gather",
    "mapreduce.shuffle.scatter",
    "mapreduce.shuffle.split",
    "mapreduce.shuffle.merge",
    "mapreduce.shuffle.pack",
    "mapreduce.shuffle.exchange",
    "mapreduce.shuffle.unpack",
    "mapreduce.reduce",
    "mapreduce.reduce.wave",
    "mapreduce.gather",
)

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str, args=None):
    """A ``record_function(name, str(args))`` range while a profiler is
    recording, else a shared ``nullcontext``; ``args`` is made a string
    only when the range is opened."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(name, None if args is None else str(args))
