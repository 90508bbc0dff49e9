"""parse_s: seconds per pipeline of FASTA parsing and read-store
building in ``run_pipeline``, a part of ``io_s`` (the port's ``io.parse``
span, from its ``STAGE_SECONDS``)."""

KEY = "io.parse"


def read(record):
    vals = [u["stages"].get(KEY) for u in record["units"]]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
