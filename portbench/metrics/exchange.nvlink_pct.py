"""The all-to-all exchange's share of its NVLink roofline, %: the live
pairs rank 0 sends the other ranks in a job, 8 B a pair, worked out from
the corpus and the hash by the reference (``exchange_bytes``), at the
card's published NVLink bandwidth a direction (``peaks.json``), over the
device time of the operations the all-to-all collective launched inside
the program's ``mapreduce.shuffle.exchange`` span, a job.  The bytes are
the same whatever implements the exchange."""

SPAN = "mapreduce.shuffle.exchange"
#: what the collective's host operation is called, as the profiler names it
NAMES = ("all_to_all", "alltoall")


def read(records):
    jobs = records.get("span_n", {}).get(SPAN)
    sent, bandwidth = records.get("exchange_bytes"), records.get("link_bytes_per_s")
    ops = records.get("span_comm_s", {}).get(SPAN, {})
    seconds = sum(s for op, s in ops.items() if any(n in op.lower() for n in NAMES))
    if not jobs or not sent or not bandwidth or not seconds:
        return None
    return 100.0 * sent * jobs / bandwidth / seconds
