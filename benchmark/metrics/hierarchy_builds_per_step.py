"""Multigrid hierarchy builds per step over the window
(``multigrid.stats["hierarchy_builds"]``)."""

UNIT = "builds/step"
LAYER = "preconditioner"


def read(rec):
    c = rec["counters"]
    return c["stats_window"]["hierarchy_builds"] / c["steps"]
