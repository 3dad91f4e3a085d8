"""Host milliseconds per step in the OC bisection over the window (the
program's ``oc.bisection`` span: bracket, bisection and the stepped
design), untraced, so with the waits at its host reads."""

from benchmark.harness import spans

UNIT = "ms/step"
LAYER = "OC step"


def read(rec):
    return spans.per_step(rec, "oc.bisection.s", 1e3)
