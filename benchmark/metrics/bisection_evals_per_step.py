"""Volume evaluations of the OC bisection per step over the window (the
program's ``oc.bisection_evals`` counter: bracket expansions, bisection
steps and the first midpoint); each runs the filter chain over the grid
and reads one scalar back to the host."""

from benchmark.harness import spans

UNIT = "evals/step"
LAYER = "OC step"


def read(rec):
    return spans.per_step(rec, "oc.bisection_evals")
