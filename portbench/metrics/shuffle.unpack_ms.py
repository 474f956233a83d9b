"""Device ms a job of the operations launched inside the program's span of
the all-to-all shuffle's unpack: the received pairs bucketed into the
worker's reduce slots (``portbench/spans.py``)."""

from portbench import spans


def read(records):
    return spans.read("shuffle.unpack_ms", records)
