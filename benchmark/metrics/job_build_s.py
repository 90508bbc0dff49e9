"""job_build_s: seconds per pipeline that the aligner's driving thread
built extension jobs and flushed them (the port's ``aligner.make_jobs``
span, from its ``STAGE_SECONDS``)."""

KEY = "aligner.make_jobs"


def read(record):
    vals = [u["stages"].get(KEY) for u in record["units"]]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
