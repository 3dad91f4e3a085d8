"""Microstructure design: match a target homogenized elasticity tensor
(counterpart of ``ndr_tpu/fem/microstructure.py``).

Adam (``torch.optim.Adam`` on one leaf tensor, the update of optax's
``adam``) on the logits of sigmoid-parameterized densities. The gradient
of the tensor-matching term is assembled from the closed-form dEh/drho
(no differentiation through the cell solves); the regularizers
(smoothness, integrality, volume) are differentiated by autograd.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, List, Optional

import numpy as np
import torch

from ndr_tpu_torch.fem import element as el
from ndr_tpu_torch.fem import homogenization as hom
from ndr_tpu_torch.grid import Grid


@dataclasses.dataclass
class MicrostructureResult:
    rho: np.ndarray
    Eh: np.ndarray
    history: List[float]


def tensor_distance(Eh: torch.Tensor, target) -> torch.Tensor:
    """Squared relative Frobenius distance ||Eh - target||^2 / ||target||^2."""
    t = torch.as_tensor(target, dtype=Eh.dtype, device=Eh.device)
    return torch.sum((Eh - t) ** 2) / torch.sum(t ** 2)


def design_microstructure(
    target_voigt,
    grid: Grid,
    material: el.IsotropicMaterial,
    rho0: Optional[torch.Tensor] = None,
    steps: int = 100,
    learning_rate: float = 0.05,
    rho_min: float = 1e-3,
    smoothness_weight: float = 0.0,
    binary_weight: float = 0.0,
    volume_target: Optional[float] = None,
    volume_weight: float = 0.0,
    cg_tol: float = 1e-9,
    log: Callable[[str], None] = lambda s: sys.stderr.write(s),
    log_every: int = 10,
    device="cuda",
) -> MicrostructureResult:
    """Adam on the logits of rho to match ``target_voigt`` (engineering
    Voigt); the cell problems solved to ``cg_tol`` (at most 2000 CG
    iterations). ``rho0=None`` starts from the uniform 0.5 float64 field on
    ``device``; a given ``rho0`` sets the dtype and device."""
    if rho0 is None:
        rho0 = torch.full(tuple(grid.dims), 0.5, dtype=torch.float64, device=device)
    degrees = tuple([grid.degree] * grid.ndim)
    K0 = torch.as_tensor(el.element_stiffness_matrix(degrees, grid.stretchings, material),
                         dtype=rho0.dtype, device=rho0.device)
    target = torch.as_tensor(target_voigt, dtype=rho0.dtype, device=rho0.device)
    t_sq = torch.sum(target ** 2)
    has_reg = bool(smoothness_weight or binary_weight or volume_weight)

    def rho_of(logits):
        return rho_min + (1.0 - rho_min) * torch.sigmoid(logits)

    def reg(rho):
        r = 0.0
        if smoothness_weight:
            for ax in range(grid.ndim):
                d = torch.diff(rho, dim=ax)
                r = r + smoothness_weight * torch.sum(d * d) / rho.numel()
        if binary_weight:
            r = r + binary_weight * torch.mean(4.0 * rho * (1.0 - rho))
        if volume_weight and volume_target is not None:
            r = r + volume_weight * (torch.mean(rho) - volume_target) ** 2
        return r

    logits = torch.log(rho0 / (1.0 - rho0 + 1e-12)).detach().requires_grad_(True)
    optimizer = torch.optim.Adam([logits], lr=learning_rate)
    history = []
    Eh = None
    for i in range(steps):
        with torch.no_grad():
            rho = rho_of(logits)
            Eh, dEh, _ = hom.homogenize(rho, grid, material, K0, tol=cg_tol)
            dist = tensor_distance(Eh, target)
            g_match = torch.einsum("st,...st->...", 2.0 * (Eh - target) / t_sq, dEh)
        g = g_match
        if has_reg:
            rho_r = rho.detach().requires_grad_(True)
            r = reg(rho_r)
            if isinstance(r, torch.Tensor):  # volume_weight without a target adds nothing
                g = g + torch.autograd.grad(r, rho_r)[0]
        with torch.no_grad():
            sig = torch.sigmoid(logits)
            logits.grad = g * ((1.0 - rho_min) * sig * (1 - sig))
        optimizer.step()
        history.append(float(dist))
        if i % log_every == 0 or i == steps - 1:
            log(f"microstructure step {i}: sq rel Frobenius distance {history[-1]:.3e}\n")
    with torch.no_grad():
        rho = rho_of(logits)
    return MicrostructureResult(rho=rho.cpu().numpy(), Eh=Eh.cpu().numpy(),
                                history=history)
