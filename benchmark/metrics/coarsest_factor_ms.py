"""Device milliseconds per traced step of the coarsest level's factor: the
kernels launched inside the program's ``mg.coarsest_factor`` span (the
dense K's assembly and its Cholesky factor or Newton-Schulz inverse)."""

from benchmark.harness import spans

UNIT = "ms/step"
LAYER = "preconditioner"


def read(rec):
    s = spans.device_s_under(rec, "mg.coarsest_factor")
    return None if s is None else 1e3 * s
