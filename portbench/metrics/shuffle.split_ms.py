"""Device ms a job of the operations launched inside the program's span of
the lexsort shuffle's split on the card (``shuffle_merge``: count, scan,
plan and the split of each task row by reducer) (``portbench/spans.py``)."""

from portbench import spans


def read(records):
    return spans.read("shuffle.split_ms", records)
