"""Plain classic SIMP with the optimality-criteria update, written from the
method's definition: the design x is smoothed by the clipped box mean of
radius r, projected by the normalized tanh of sharpness beta about 0.5,
and moved by x * sqrt(-dc/dx / (lambda dV/dx)), clipped to the move limit
and to [0, 1], with lambda the root of the volume constraint.

``judge_step`` holds one step of the program to this: the program's
displacement by its residual under K of the reference's own filtered
density, in float64; the program's next design against the reference's
update from the same design and displacement, everything in float64 but
the adjoint's element energies u_e^T K0 u_e, which the configuration
states in float32 (u rounded to float32, products in float32, TF32 off).
In float32 those energies lose their low digits to the rigid-body part of
u_e, so against float64 energies the program's update is off by a few
percent of its step at 256x128x128: the stated precision's error, and as
large as a lower precision's, so it could tell neither apart."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import fem, solve
from benchmark.reference.precision import exact_float32, fp32_matmul


def physical_density(x: torch.Tensor, radius: int, beta: float) -> torch.Tensor:
    s = F.avg_pool3d(x[None, None], 2 * radius + 1, stride=1, padding=radius,
                     count_include_pad=False)[0, 0]
    t = math.tanh(0.5 * beta)
    return 0.5 * (t + torch.tanh(beta * (s - 0.5))) / t


def oc_update(prob: fem.Problem, x: torch.Tensor, u: torch.Tensor, radius: int,
              beta: float, move: float, matmul=torch.matmul,
              dtype=torch.float64, ctol: float = 0.0) -> torch.Tensor:
    """The next design from design ``x`` and its displacement ``u``, all in
    ``dtype``; lambda bisected until the volume is met to ``ctol`` (0: until
    the bracket closes to 1e-14 of lambda)."""
    xx = x.to(dtype).detach().requires_grad_(True)
    rho = physical_density(xx, radius, beta)
    dcdrho = fem.compliance_grad_rho(prob, rho.detach(), u.to(dtype), matmul).to(dtype)
    dc = torch.autograd.grad(rho, xx, dcdrho, retain_graph=True)[0]
    dv = torch.autograd.grad(-rho.mean() / prob.volume, xx)[0]
    x0 = xx.detach()
    lo, hi = torch.clamp(x0 - move, min=0.0), torch.clamp(x0 + move, max=1.0)
    ratio = torch.clamp(dc / dv, min=0.0)   # both negative where they matter

    def step(lam):
        return torch.minimum(torch.maximum(x0 * torch.sqrt(ratio / lam), lo), hi)

    def excess(lam):   # increasing in lam
        with torch.no_grad():
            return 1.0 - float(physical_density(step(lam), radius, beta).mean()) / prob.volume

    a = b = float(ratio.mean())
    while excess(a) > 0:
        a *= 0.5
    while excess(b) < 0:
        b *= 2.0
    for _ in range(200):
        if b - a <= 1e-14 * b:
            break
        m = 0.5 * (a + b)
        v = excess(m)
        if abs(v) <= ctol or v == 0:
            a = b = m
        elif v < 0:
            a = m
        else:
            b = m
    with torch.no_grad():
        return step(0.5 * (a + b))


def judge_step(prob: fem.Problem, x: torch.Tensor, u: torch.Tensor, x_next: torch.Tensor,
               radius: int, beta: float, move: float) -> dict:
    """One step's readings, in float64: "residual" ||f - K(rho(x)) u|| / ||f||;
    "oc_step" ||x_next - x_ref|| / ||x_ref - x||, the gap to the reference
    update x_ref as a share of the step it makes; "oc_step_max" the widest
    gap of one element, max |x_next - x_ref|."""
    exact_float32()
    x = x.to(prob.K0.device, torch.float64)
    u = u.to(prob.K0.device, torch.float64)
    with torch.no_grad():
        rho = physical_density(x, radius, beta)
    res = fem.residual(prob, rho, u)
    ref = oc_update(prob, x, u, radius, beta, move, matmul=fp32_matmul)
    diff = x_next.to(ref.device, torch.float64) - ref
    return {"residual": res,
            "oc_step": float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(ref - x)),
            "oc_step_max": float(diff.abs().max())}


def control_step(prob32: fem.Problem, x: torch.Tensor, tol: float, cg_iter: int,
                 radius: int, beta: float, move: float, ctol: float, matmul) -> tuple:
    """The reference in the program's place one precision down: the solve in
    float32 with no float64 refinement, every element product through
    ``matmul`` (TF32 operands), the update in float32. Returns (u, x_next)."""
    x = x.to(prob32.K0.device, torch.float32)
    with torch.no_grad():
        rho = physical_density(x, radius, beta)
    u, _, _ = solve.solve(prob32, rho, tol, cg_iter, matmul=matmul)
    x_next = oc_update(prob32, x, u, radius, beta, move, matmul=matmul,
                       dtype=torch.float32, ctol=ctol)
    return u, x_next
