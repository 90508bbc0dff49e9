"""stage_s.masks: seconds of the masks and mapping stage (``pipeline.masks_for``) per
pipeline, from the port's ``STAGE_SECONDS``."""

KEY = ".masks_for"


def read(record):
    vals = [next((v for k, v in u["stages"].items() if k.endswith(KEY)), None)
            for u in record["units"]]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
