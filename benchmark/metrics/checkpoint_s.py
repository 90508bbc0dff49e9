"""checkpoint_s: seconds per pipeline of the workdir checkpoints that
``close_gaps`` writes (the port's ``io.checkpoint`` span, from its
``STAGE_SECONDS``)."""

KEY = "io.checkpoint"


def read(record):
    vals = [u["stages"].get(KEY) for u in record["units"]]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
