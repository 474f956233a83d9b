"""Device ms a job of the operations launched inside the program's span of
the map tasks' stable spill sorts and their gathers
(``portbench/spans.py``)."""

from portbench import spans


def read(records):
    return spans.read("map.spill_sort_ms", records)
