"""Device ms a job of the operations launched inside the program's span of
the all-to-all shuffle's pack: each worker's pairs partitioned by
destination worker (``portbench/spans.py``)."""

from portbench import spans


def read(records):
    return spans.read("shuffle.pack_ms", records)
