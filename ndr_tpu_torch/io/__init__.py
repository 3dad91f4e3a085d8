"""Problem / boundary-condition / material file IO."""

from ndr_tpu_torch.io.problem import (  # noqa: F401
    BoundaryConditions,
    load_bcs,
    load_material,
    load_problem,
    ProblemConfig,
)
