"""peak_host_gib: the measured process's peak resident memory (GiB),
read when the window closes, before the check."""


def read(record):
    return record["peak_host_gib"]
