"""device_idle_pct: the share of the window's pipelines' walls in which
no kernel, copy or set ran on the card (the union of the trace's device
intervals)."""


def read(record):
    tr = record["trace"]
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
