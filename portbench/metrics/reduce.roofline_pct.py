"""The reduce phase's share of its memory roofline, %: each live pair of
the partitions read once (the shuffle's ``pairs_out``) and each segment
written once (``segments_out``), 8 B a pair."""

from portbench.readers import counter, roofline_pct


def read(records):
    return roofline_pct(
        records, "reduce",
        lambda t: counter(t, "shuffle", "pairs_out") + counter(t, "reduce", "segments_out"))
