"""stage_s.validation: seconds of the validation pass (``pipeline._validation_pass``) per
pipeline, from the port's ``STAGE_SECONDS``."""

KEY = "._validation_pass"


def read(record):
    vals = [next((v for k, v in u["stages"].items() if k.endswith(KEY)), None)
            for u in record["units"]]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
