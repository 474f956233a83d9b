"""Device ms a job of the operations launched inside the program's span of
the all-to-all shuffle's exchange: the blocks' live width and the
``all_to_all_single`` (``portbench/spans.py``)."""

from portbench import spans


def read(records):
    return spans.read("shuffle.exchange_ms", records)
