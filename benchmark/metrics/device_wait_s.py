"""device_wait_s: seconds per pipeline that the threads driving the
aligner and consensus blocked on kernel results (the port's
``wait.device`` span, from its ``STAGE_SECONDS``)."""

KEY = "wait.device"


def read(record):
    vals = [u["stages"].get(KEY) for u in record["units"]]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
