"""setup_s: imports, loading the kernel library and one warm-up
pipeline of the cell's size (the generator's seconds left out)."""


def read(record):
    return record["setup_s"]
