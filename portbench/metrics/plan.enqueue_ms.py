"""The mean host time for a window job's call to return, before the fence
that waits for its device work, ms."""


def read(records):
    enqueue = records.get("enqueue_s")
    return 1e3 * sum(enqueue) / len(enqueue) if enqueue else None
