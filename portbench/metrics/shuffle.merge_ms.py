"""Device ms a job of the operations launched inside the program's span of
the lexsort shuffle's merge rounds on the card, into the partitions and
their tails (``portbench/spans.py``)."""

from portbench import spans


def read(records):
    return spans.read("shuffle.merge_ms", records)
