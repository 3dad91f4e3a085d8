"""Full-field forwards of the network per step over the window (the
program's ``mlp_forwards`` counter; backward's recompute of the chunks is
not one)."""

from benchmark.harness import spans

UNIT = "forwards/step"
LAYER = "model"


def read(rec):
    return spans.per_step(rec, "mlp_forwards")
