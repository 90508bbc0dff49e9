"""first_call_s: the wall of the warm-up pipeline, a process's first
``run_pipeline`` call."""


def read(record):
    return record["first_call_s"]
