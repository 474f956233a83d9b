"""Device ms a job of the operations launched inside the program's span of
the sharded mode's output all-gather, which hands every rank the whole
output (``portbench/spans.py``)."""

from portbench import spans


def read(records):
    return spans.read("gather.device_ms", records)
