"""Device milliseconds per traced step of the multigrid hierarchy build:
the kernels launched inside the program's ``mg.hierarchy_build`` span
(Galerkin stacks, diagonal blocks, stencil assembly)."""

from benchmark.harness import spans

UNIT = "ms/step"
LAYER = "preconditioner"


def read(rec):
    s = spans.device_s_under(rec, "mg.hierarchy_build")
    return None if s is None else 1e3 * s
