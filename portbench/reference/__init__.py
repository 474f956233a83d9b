"""The plain reference: what a MapReduce job's output must be.

It works the whole job out again from the corpus, with no code of the
program: the map (records parsed from each split's own start, so a split
that does not start on a record emits shifted fields), the map-side
combine with its per-task row width, the hash partition and the capacity
that drops pairs, and the reduce.  It counts where the program sorts one
pair at a time: per (task, key) counts and exact int64 sums, then each
entry's first slot in its reducer's bucket from running sums over those
entries, then the values wrapped as the program's int32 sums wrap.  It runs
on whichever device holds the corpus.

``expected`` gives the layout the program's ``(R, cap)`` output must have,
slot for slot; ``mismatches`` counts the slots, and the dropped pairs,
that differ from it.  ``wrap(vals, 16)`` gives the same reference's values
summed in 16-bit integers, as those sums wrap: the control, one precision
below the int32 sums that the configurations state.
"""

from portbench.reference.mapreduce import (
    PAD_KEY,
    Expected,
    JobShape,
    Output,
    expected,
    hash_to_reducer,
    mismatches,
    partition_capacity,
    wrap,
)

__all__ = [
    "PAD_KEY",
    "Expected",
    "JobShape",
    "Output",
    "expected",
    "hash_to_reducer",
    "mismatches",
    "partition_capacity",
    "wrap",
]
