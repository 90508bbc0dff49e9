"""io_s: seconds of ``run_pipeline`` outside ``close_gaps`` (the FASTA
parse and the output writes), per pipeline."""


def _stage(u, suffix):
    return next((v for k, v in u["stages"].items() if k.endswith(suffix)), None)


def read(record):
    vals = [_stage(u, ".run_pipeline") - _stage(u, ".close_gaps")
            for u in record["units"]
            if _stage(u, ".run_pipeline") is not None
            and _stage(u, ".close_gaps") is not None]
    return sum(vals) / len(vals) if vals else None
