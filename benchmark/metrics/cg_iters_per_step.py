"""CG iterations per step over the window, summed over each step's
refinement passes, from the entry's per-step log lines."""

UNIT = "iters/step"
LAYER = "solve"


def read(rec):
    c = rec["counters"]
    return c["cg_iters"] / c["steps"]
