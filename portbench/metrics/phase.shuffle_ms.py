"""The shuffle phase's mean wall over the traced mode's jobs, ms."""

from portbench.readers import phase_ms


def read(records):
    return phase_ms(records, "shuffle")
