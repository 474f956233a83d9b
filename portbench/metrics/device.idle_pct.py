"""The share of the profiled fused jobs' window in which no operation ran
on the device, %."""


def read(records):
    busy, window = records.get("busy_s"), records.get("window_s")
    if not busy or not window:
        return None
    return 100.0 * (1.0 - busy / window)
