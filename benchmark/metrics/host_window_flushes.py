"""host_window_flushes: K1p launches (extension flushes on host-built
windows, taken when the reads overflow the device store) per pipeline,
from the port's launch counters."""


def read(record):
    units = record["units"]
    if not units:
        return None
    return sum(u["launches"].get("K1p", 0) for u in units) / len(units)
