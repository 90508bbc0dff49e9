"""extend_roofline: the window's K1 and K1p launches' summed
roofline bounds (``benchmark/roofline.py``, from each launch's own
arguments) over their summed device time in the profiler's trace."""


def read(record):
    tr = record["trace"]
    if not tr or not tr.get("k1_bound_s") or not tr.get("k1_device_s"):
        return None
    return 100.0 * tr["k1_bound_s"] / tr["k1_device_s"]
