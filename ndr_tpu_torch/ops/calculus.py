"""Differential operators of coordinate fields (counterpart of
``ndr_tpu/ops/calculus.py``; the reference's utils.py gradient /
divergence / laplace).

As in the JAX package these are function transforms: pass the field
``fn``, written for ONE coordinate ``(ndim,) -> ()`` (scalar field) or
``(ndim,) -> (ndim,)`` (vector field) in torch ops, and get back a
function over batched coordinates ``(..., ndim)``, through ``torch.func``
(``vmap`` over the points, ``grad`` / ``jacfwd`` / ``hessian`` at each).
Used for PDE-style regularizers on neural density fields.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, hessian, jacfwd, vmap


def _batched(point_op: Callable) -> Callable:
    """Lift a single-point operator to any leading batch dims."""

    def apply(coords: torch.Tensor) -> torch.Tensor:
        flat = coords.reshape(-1, coords.shape[-1])
        out = vmap(point_op)(flat)
        return out.reshape(coords.shape[:-1] + out.shape[1:])

    return apply


def gradient(fn: Callable) -> Callable:
    """The per-point gradient of a scalar field, over ``(..., ndim)``."""
    return _batched(grad(fn))


def divergence(fn: Callable) -> Callable:
    """The per-point divergence of a vector field: the trace of its
    Jacobian, by forward mode (one JVP per dim)."""
    return _batched(lambda x: torch.trace(jacfwd(fn)(x)))


def laplacian(fn: Callable) -> Callable:
    """The per-point Laplacian of a scalar field: the trace of its Hessian
    (forward over reverse)."""
    return _batched(lambda x: torch.trace(hessian(fn)(x)))


# the reference's name (utils.laplace)
laplace = laplacian
