"""The combine phase's share of its memory roofline, %: each map pair read
once (``pairs_in``) and each combined pair written once (``pairs_out``),
8 B a pair."""

from portbench.readers import counter, roofline_pct


def read(records):
    return roofline_pct(
        records, "combine",
        lambda t: counter(t, "combine", "pairs_in") + counter(t, "combine", "pairs_out"))
