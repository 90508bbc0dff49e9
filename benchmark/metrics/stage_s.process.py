"""stage_s.process: seconds of consensus (``stage.process``) per
pipeline, from the port's ``STAGE_SECONDS``."""

KEY = "stage.process"


def read(record):
    vals = [next((v for k, v in u["stages"].items() if k.endswith(KEY)), None)
            for u in record["units"]]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None
