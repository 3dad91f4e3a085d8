"""Blocking device-to-host reads per step over the window: the program's
``host_reads`` counter, which its one read helper (``timers.read``) adds to
at each read on the step's path (the CG stop tests, the refinement's
norms, the OC bisection's volume evaluations, the metrics' read-back) and
beside the Cholesky factorization's own error check."""

from benchmark.harness import spans

UNIT = "reads/step"
LAYER = "driver"


def read(rec):
    return spans.per_step(rec, "host_reads")
