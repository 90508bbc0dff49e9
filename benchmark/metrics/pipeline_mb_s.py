"""pipeline_mb_s: assembly megabases of the window's pipelines over the
sum of their walls."""


def read(record):
    units = record["units"]
    wall = sum(u["wall_s"] for u in units)
    return sum(u["mb"] for u in units) / wall if wall > 0 else None
