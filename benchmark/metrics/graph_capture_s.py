"""Seconds the run spent capturing the preconditioner's CUDA graphs
(``multigrid.stats["graph_capture_seconds"]``); nothing where it captured
none."""

UNIT = "s"
LAYER = "preconditioner"


def read(rec):
    s = rec["counters"]["stats_total"]
    if not s.get("graph_captures"):
        return None
    return s["graph_capture_seconds"]
