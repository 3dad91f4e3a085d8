"""Volume constraint and constraint-satisfaction operators (counterpart of
``ndr_tpu/ops/volume.py``).

  * :func:`total_volume_constraint` — c = 1 - mean(rho)/v_max, and its
    constant gradient :func:`total_volume_constraint_grad`.
  * :func:`find_root` — bisection for the shift b such that
    mean(projection(x + b)) == target, with the implicit-function
    gradient as a ``torch.autograd.Function``.
  * :func:`sigmoid_with_constrained_mean` and the other hard satisfiers.
  * soft penalty modes (add_mean / one_sided_max / maxed_barrier /
    thresholded_barrier) with the loss-ratio scaler.

The bisection runs on the device as a fixed 128 iterations that freeze
the bracket once it is narrower than 1e-12: the JAX while-loop's result
exactly, without one host read per iteration.
"""

from __future__ import annotations

from typing import Callable

import torch

_BISECT_ITERS = 128
_BISECT_WIDTH = 1e-12


def total_volume_constraint(rho: torch.Tensor, max_volume: float) -> torch.Tensor:
    """c = 1 - mean(rho) / v_max  (>= 0 feasible, 0 when active)."""
    return 1.0 - torch.mean(rho) / max_volume


def total_volume_constraint_grad(rho: torch.Tensor, max_volume: float) -> torch.Tensor:
    """Constant gradient -1/(v_max * N_e)."""
    return torch.full_like(rho, -1.0 / (max_volume * rho.numel()))


def logit(p: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(p, 0.0, 1.0)
    return torch.log(p) - torch.log1p(-p)


def _bisect(x: torch.Tensor, target: torch.Tensor, projection: Callable) -> torch.Tensor:
    """The JAX ``lax.while_loop`` bisection (stop at width < 1e-12 or 128
    iterations) as 128 device steps that stop moving the bracket once the
    width test holds."""
    lo = logit(target) - torch.amax(x)
    hi = logit(target) - torch.amin(x)
    for _ in range(_BISECT_ITERS):
        active = (hi - lo) >= _BISECT_WIDTH
        mid = 0.5 * (lo + hi)
        f = torch.mean(projection(x + mid)) - target
        lo = torch.where(active & ~(f > 0), mid, lo)
        hi = torch.where(active & (f > 0), mid, hi)
    return 0.5 * (lo + hi)


class _FindRoot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, target, projection):
        x = x.detach()
        t = torch.as_tensor(target, dtype=x.dtype, device=x.device)
        b = _bisect(x, t, projection)
        # f(x, b) = mean(projection(x + b)) - target; its gradients by
        # autograd, so any monotone projection works
        with torch.enable_grad():
            xx = x.requires_grad_(True)
            bb = b.detach().requires_grad_(True)
            f = torch.mean(projection(xx + bb)) - t
            dfdx, dfdb = torch.autograd.grad(f, (xx, bb))
        ctx.save_for_backward(dfdx, dfdb)
        return b

    @staticmethod
    def backward(ctx, g):
        dfdx, dfdb = ctx.saved_tensors
        return -dfdx / dfdb * g, None, None


def find_root(x: torch.Tensor, target, projection: Callable) -> torch.Tensor:
    """Solve mean(projection(x + b)) == target for the scalar shift b.

    Monotone bisection (projection must be elementwise increasing), with
    the gradient db/dx = -(df/dx) / (df/db) of the implicit function
    theorem, f(x, b) = mean(projection(x + b)) - target. The initial
    bracket is [logit(t) - max(x), logit(t) - min(x)].
    """
    return _FindRoot.apply(x, target, projection)


def sigmoid_with_constrained_mean(x, target, projection=torch.sigmoid):
    """Project x through ``projection`` with the mean constrained to
    ``target``."""
    b = find_root(x, target, projection)
    return projection(x + b)


def projection_filter_with_constrained_mean(x, target, beta=1.0):
    """The same through the unnormalized tanh projection
    0.5 tanh(beta x) + 0.5."""
    def proj(v):
        return 0.5 * torch.tanh(beta * v) + 0.5
    b = find_root(x, target, proj)
    return proj(x + b)


def compute_volume_loss_scaler(compliance_loss, volume_loss, mode="clip",
                               constant=500.0):
    """Weight for the soft volume penalty (no gradient flows through it)."""
    scaler = (compliance_loss / volume_loss).detach()
    if mode == "clip":
        return torch.clamp(scaler, max=constant)
    if mode == "equalize":
        return scaler
    raise ValueError(f"unknown scaler mode {mode!r}")


def satisfy_volume_constraint(
    density,
    max_volume,
    compliance_loss=None,
    mode="constrained_sigmoid",
    scaler_mode="clip",
    constant=500.0,
    beta=1.0,
):
    """Hard modes return the constrained density field; soft modes return
    a scalar penalty term to add to the loss."""
    current = torch.mean(density)

    if mode == "constrained_sigmoid":
        return sigmoid_with_constrained_mean(density, max_volume)
    if mode == "constrained_projection":
        return projection_filter_with_constrained_mean(density, max_volume, beta=beta)

    if mode == "add_mean":
        vloss = torch.abs(current - max_volume)
    elif mode == "one_sided_max":
        vloss = torch.clamp(current - max_volume, min=0.0) ** 2
    elif mode == "maxed_barrier":
        eps = 1e-7
        vloss = torch.clamp(-torch.log(1.0 + max_volume + eps - current), min=0.0)
    elif mode == "thresholded_barrier":
        eps = 1e-7
        a = torch.where(current <= max_volume, 1.0 + max_volume + eps - current,
                        torch.ones_like(current))
        vloss = torch.log(a / (1.0 + max_volume + eps - current)) ** 2
    else:
        raise ValueError(f"unknown volume constraint mode {mode!r}")

    scaler = compute_volume_loss_scaler(compliance_loss, vloss, scaler_mode, constant)
    return vloss * scaler


def is_hard_mode(mode: str) -> bool:
    """Whether ``mode`` constrains the field (True) or penalizes the loss."""
    hard = {"constrained_sigmoid": True, "constrained_projection": True,
            "add_mean": False, "one_sided_max": False,
            "maxed_barrier": False, "thresholded_barrier": False}
    if mode not in hard:
        raise ValueError(f'The mode "{mode}" does not exist')
    return hard[mode]
