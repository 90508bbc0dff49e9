"""seed_wait_s: seconds per pipeline that the aligner's driving thread
waited on its seeding pool (the port's ``aligner.seed_wait`` span, from
its ``STAGE_SECONDS``)."""

KEY = "aligner.seed_wait"


def read(record):
    vals = [u["stages"].get(KEY) for u in record["units"]]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
