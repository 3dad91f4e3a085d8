"""FEMProblem: an elasticity problem on a voxel grid as device tensors
(counterpart of ``ndr_tpu/fem/simulator.py``)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ndr_tpu_torch.fem import element as el
from ndr_tpu_torch.grid import Grid
from ndr_tpu_torch.io.problem import BoundaryConditions, ProblemConfig, load_bcs, load_material
from ndr_tpu_torch.fem import operators as ops
from ndr_tpu_torch.utils import timers


@dataclasses.dataclass(frozen=True)
class FEMProblem:
    """Static elasticity problem on a voxel grid.

    ``K0`` is always float64: rounding it to fp32 perturbs the element
    matrix's exact rigid-body null space, which smooth modes amplify into
    percent-level compliance errors. Consumers cast it to their working
    dtype themselves; the mixed-precision refinement measures residuals
    against the float64 operator.
    """

    K0: torch.Tensor                # (d_pe, d_pe) float64
    dirichlet_mask: torch.Tensor    # bool, nodes_per_dim + (N,)
    force: torch.Tensor             # nodes_per_dim + (N,)
    grid: Grid
    E0: float = 1.0
    Emin: float = 1e-4
    gamma: float = 3.0

    @property
    def device(self) -> torch.device:
        return self.force.device

    def young(self, rho: torch.Tensor) -> torch.Tensor:
        return ops.element_young_modulus(rho, self.E0, self.Emin, self.gamma)

    def zero_dirichlet(self, u: torch.Tensor) -> torch.Tensor:
        return ops.zero_dirichlet(u, self.dirichlet_mask)

    def compliance_gradient(self, u: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
        return ops.compliance_gradient(
            u, rho, self.K0, self.grid, self.E0, self.Emin, self.gamma
        )


def problem_from_numpy(
    K0: np.ndarray,
    force: np.ndarray,
    dirichlet_mask: np.ndarray,
    grid: Grid,
    E0: float,
    Emin: float,
    gamma: float,
    device,
    dtype: torch.dtype = torch.float64,
) -> FEMProblem:
    """Build a FEMProblem from numpy arrays, e.g. those of an
    ``ndr_tpu.fem.simulator.FEMProblem`` (K0, force, Dirichlet mask)."""
    return FEMProblem(
        K0=torch.tensor(np.asarray(K0, np.float64), device=device),
        dirichlet_mask=torch.tensor(np.asarray(dirichlet_mask, bool),
                                    device=device),
        force=torch.tensor(np.asarray(force), device=device).to(dtype),
        grid=grid,
        E0=float(E0),
        Emin=float(Emin),
        gamma=float(gamma),
    )


def build_problem(
    grid: Grid,
    material: el.IsotropicMaterial,
    bcs: BoundaryConditions,
    E0: float = 1.0,
    Emin: float = 1e-4,
    gamma: float = 3.0,
    dtype: torch.dtype = torch.float64,
    device="cuda",
) -> FEMProblem:
    """Assemble a FEMProblem from geometry, material, and nodal BCs.
    ``dtype`` is the force field's (working) dtype; K0 stays float64."""
    K0 = el.element_stiffness_matrix(
        tuple([grid.degree] * grid.ndim), grid.stretchings, material
    )
    return problem_from_numpy(K0, bcs.force, bcs.dirichlet_mask, grid,
                              E0, Emin, gamma, device=device, dtype=dtype)


@timers.span("setup.problem")
def problem_from_config(
    cfg: ProblemConfig, dims=None, dtype: torch.dtype = torch.float64,
    device="cuda",
) -> Tuple[FEMProblem, Grid]:
    """Build a FEMProblem from a problem-JSON config on ``device`` (the
    card unless the caller asks for the CPU)."""
    grid = cfg.make_grid(dims)
    material = load_material(cfg.material_path, grid.ndim)
    bcs = load_bcs(cfg.bc_path, grid)
    prob = build_problem(
        grid, material, bcs,
        E0=cfg.E0, Emin=cfg.Emin, gamma=cfg.simp_exponent, dtype=dtype,
        device=device,
    )
    return prob, grid
