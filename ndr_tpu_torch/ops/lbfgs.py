"""Bound-constrained L-BFGS optimizer for classic SIMP (counterpart of
``ndr_tpu/ops/lbfgs.py``, the reference's IPOPT limited-memory mode).

The reference's second optimizer wraps the TO problem in cyipopt (box
bounds [0, 1] on the densities, one volume inequality on the FILTERED
density). As in the JAX package it is solved here with an
augmented-Lagrangian scheme:

  * outer loop: AL multiplier updates for the scalar volume inequality
    g(x) = mean(physical(x)) - v_max (lambda <- max(0, lambda + mu g); mu
    grown while g stays positive);
  * inner loop: box-projected L-BFGS (two-loop recursion over a ring
    buffer of curvature pairs, clip-to-[0, 1] projection, Armijo
    backtracking from the natural step 1) on the AL objective
    c(x) + mu/2 max(0, lambda/mu + g)^2 - lambda^2/(2 mu);
  * a final feasibility restoration: bisection on a uniform shift of the
    design until the filtered volume meets v_max.

The compliance gradient is the closed-form adjoint; the volume gap's
gradient is autograd through the filter chain. The two-loop recursion and
the bisection run on the device; the host reads the scalars the JAX
package reads (objective values, the gap, the curvature s.y, the descent
test) and nothing else.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, List, Optional

import torch

from ndr_tpu_torch.fem import topopt as topo


def project_feasible(x: torch.Tensor, max_volume: float, density_fn=None) -> torch.Tensor:
    """Feasibility restoration: the shift b <= 0 for which
    ``mean(density_fn(clip(x + b))) == max_volume``, found by 80 bisection
    steps on the device, and clip(x + b). With ``density_fn`` the filter
    chain this holds the constraint on the PHYSICAL density, the
    reference's semantics; the map is monotone in b (clip, the smoothing
    mean and the tanh projection all are). Only infeasible designs move."""
    if density_fn is None:
        density_fn = lambda v: v

    def f(b):
        return torch.mean(density_fn(torch.clamp(x + b, 0.0, 1.0))) - max_volume

    with torch.no_grad():
        lo = -torch.max(x)          # clip(x + lo) is 0 somewhere: mean < v_max
        hi = 1.0 - torch.min(x)     # clip(x + hi) is 1 everywhere: mean > v_max
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            pos = f(mid) > 0
            lo, hi = torch.where(pos, lo, mid), torch.where(pos, mid, hi)
        b = torch.clamp(0.5 * (lo + hi), max=0.0)
        return torch.clamp(x + b, 0.0, 1.0)


@dataclasses.dataclass
class LBFGSResult:
    x: torch.Tensor               # final design, on the problem's device
    history: List[float]          # 2 c at the start of each inner iteration, then the final
    evaluations: int              # objective + gradient evaluations (one solve each)
    step_seconds: List[float]     # wall time of each inner iteration


def _two_loop(g, s_hist, y_hist, rho_hist, n_pairs: int, m: int) -> torch.Tensor:
    """The approximate H^-1 g of the ring-buffered curvature pairs, in the
    JAX package's order: backward from the newest pair, then forward over
    the ring's slots 0 .. m-1 that hold pairs. That forward pass reads
    slot numbers as pair ages, so once n_pairs > m it skips the newest
    pairs and from n_pairs >= 2m it is empty: a fault of both packages,
    kept here for parity (ROADMAP.md, Queue 3)."""
    q = g
    alphas = [None] * m
    for i in range(min(n_pairs, m)):
        idx = (n_pairs - 1 - i) % m
        a = rho_hist[idx] * torch.dot(s_hist[idx].reshape(-1), q.reshape(-1))
        q = q - a * y_hist[idx]
        alphas[idx] = a
    if n_pairs > 0:
        last = (n_pairs - 1) % m
        sy = torch.dot(s_hist[last].reshape(-1), y_hist[last].reshape(-1))
        yy = torch.dot(y_hist[last].reshape(-1), y_hist[last].reshape(-1))
        r = (sy / torch.clamp(yy, min=1e-30)) * q
    else:
        r = q
    for i in range(max(n_pairs - m, 0), min(n_pairs, m)):
        b = rho_hist[i] * torch.dot(y_hist[i].reshape(-1), r.reshape(-1))
        r = r + (alphas[i] - b) * s_hist[i]
    return r


def lbfgs_topopt(
    top: topo.TopologyOptimizationProblem,
    x0: torch.Tensor,
    max_iter: int = 100,
    memory: int = 10,
    step_size: float = 0.05,
    outer_iters: int = 6,
    ctol: float = 1e-4,
    log: Callable[[str], None] = lambda s: sys.stderr.write(s),
    log_every: int = 10,
    callback: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> LBFGSResult:
    """Augmented-Lagrangian L-BFGS on compliance with box bounds and the
    filtered-volume inequality; ``max_iter`` bounds the TOTAL number of
    inner iterations over all multiplier updates. History values are
    2 c, the reference's loss convention. ``callback(k, x)`` runs after
    inner iteration k (counted over all multiplier updates, from 0), with
    the design it ended on, outside its timed span."""
    m = memory
    x = torch.clamp(x0, 0.0, 1.0)
    u = torch.zeros_like(top.prob.force)
    evaluations = 0

    def eval_core(x, u):
        """Compliance by the solve, its adjoint gradient, and the volume
        gap with its gradient through the filter chain."""
        nonlocal evaluations
        evaluations += 1
        c, u_new, _ = top.objective(x, u)
        gc = top.objective_gradient(x, u_new)
        xx = x.detach().requires_grad_(True)
        gap = torch.mean(top.physical_density(xx)) - top.max_volume
        gv, = torch.autograd.grad(gap, xx)
        return c, gc, gap.detach(), gv, u_new

    def eval_al(x, u, lam, mu):
        c, gc, g, gv, u_new = eval_core(x, u)
        t = max(0.0, lam + mu * float(g))
        phi = float(c) + (t * t - lam * lam) / (2.0 * mu)
        return phi, gc + t * gv, c, g, u_new

    def reset_memory():
        return (torch.zeros((m,) + x.shape, dtype=x.dtype, device=x.device),
                torch.zeros((m,) + x.shape, dtype=x.dtype, device=x.device),
                torch.zeros((m,), dtype=x.dtype, device=x.device), 0)

    history: List[float] = []
    step_seconds: List[float] = []
    # warm multiplier: the KKT least-squares estimate -<grad c, grad g> /
    # |grad g|^2, so the first inner solve minimizes (roughly) the right
    # Lagrangian; the penalty makes a typical violation cost a few percent
    c0, gc0, gap0, gv0, u = eval_core(x, u)
    vv = torch.clamp(torch.dot(gv0.reshape(-1), gv0.reshape(-1)), min=1e-30)
    lam = max(0.0, float(-torch.dot(gc0.reshape(-1), gv0.reshape(-1)) / vv))
    mu = float(10.0 * torch.abs(c0) / torch.clamp(torch.abs(gap0), min=1e-2))
    c, gap = c0, gap0
    it_total = 0
    for outer in range(outer_iters):
        s_hist, y_hist, rho_hist, n_pairs = reset_memory()
        phi, gphi, c, gap, u = eval_al(x, u, lam, mu)
        inner_budget = max(max_iter // outer_iters, 10)
        stalls = 0
        for _ in range(inner_budget):
            if it_total >= max_iter:
                break
            t0 = time.perf_counter()
            d = _two_loop(gphi, s_hist, y_hist, rho_hist, n_pairs, m)
            quasi_newton = float(torch.dot(gphi.reshape(-1), d.reshape(-1))) > 0.0
            if not quasi_newton:
                d = gphi
            # Armijo backtracking from the natural quasi-Newton step
            alpha = 1.0 if (quasi_newton and n_pairs > 0) else step_size
            accepted = False
            for _ in range(16):
                x_new = torch.clamp(x - alpha * d, 0.0, 1.0)
                phi_new, gphi_new, c_new, gap_new, u_try = eval_al(x_new, u, lam, mu)
                if phi_new <= phi:
                    accepted = True
                    break
                alpha *= 0.4
            it_total += 1
            history.append(2.0 * float(c))
            if accepted:
                stalls = 0
                u = u_try
                s = x_new - x
                yv = gphi_new - gphi
                sy = float(torch.dot(s.reshape(-1), yv.reshape(-1)))
                if sy > 1e-12:
                    idx = n_pairs % m
                    s_hist[idx] = s
                    y_hist[idx] = yv
                    rho_hist[idx] = 1.0 / sy
                    n_pairs += 1
                x, phi, gphi, c, gap = x_new, phi_new, gphi_new, c_new, gap_new
            else:
                s_hist, y_hist, rho_hist, n_pairs = reset_memory()
                stalls += 1
            step_seconds.append(time.perf_counter() - t0)
            if callback is not None:
                callback(it_total - 1, x)
            if not accepted:
                if stalls >= 2:
                    break       # the inner problem converged
                continue
            if it_total % log_every == 0:
                log(f"LBFGS outer {outer} iter {it_total}: compliance "
                    f"{2.0 * float(c):.6f}, gap {float(gap):+.2e}, "
                    f"lambda {lam:.3g}\n")
        # multiplier update; grow the penalty while infeasible
        lam = max(0.0, lam + mu * float(gap))
        if float(gap) > ctol:
            mu *= 4.0
        if it_total >= max_iter:
            break
        if abs(float(gap)) <= ctol and lam > 0.0 and outer >= 1:
            break       # feasible with a settled multiplier
    # feasibility restoration (the constraint is active at the optimum)
    x = project_feasible(x, top.max_volume, top.physical_density)
    c, _, _, _, u = eval_core(x, u)
    history.append(2.0 * float(c))
    with torch.no_grad():
        vol = float(torch.mean(top.physical_density(x)))
    log(f"LBFGS final: compliance {2.0 * float(c):.6f}, vol {vol:.4f}\n")
    return LBFGSResult(x=x, history=history, evaluations=evaluations,
                       step_seconds=step_seconds)
