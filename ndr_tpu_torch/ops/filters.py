"""Solver-side density filters, differentiable under autograd
(counterpart of the classic-path part of ``ndr_tpu/ops/filters.py``).

All filters operate on density fields of shape ``grid.dims``; autograd
through the forward pass gives the reference's hand-written backprop.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F


class Filter:
    """Filter protocol: ``apply(x) -> x_filtered`` (differentiable)."""

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass
class ProjectionFilter(Filter):
    """Normalized tanh Heaviside projection about 0.5:
    out = 0.5 * (tanh(0.5 b) + tanh(b (x - 0.5))) / tanh(0.5 b)."""

    beta: float = 1.0

    def apply(self, x):
        b = self.beta
        t = math.tanh(0.5 * b)
        return 0.5 * (t + torch.tanh(b * (x - 0.5))) / t


@dataclasses.dataclass
class SmoothingFilter(Filter):
    """Cube-neighborhood mean with boundary-clipped stencils: each cell
    averages over the in-bounds part of the radius-r cube around it.

    ``avg_pool`` with ``count_include_pad=False`` is exactly the clipped
    window sum divided by the clipped count, and its autograd is the
    transpose."""

    radius: int = 1

    def apply(self, x):
        r = int(round(self.radius))
        if r <= 0:
            return x
        pool = {2: F.avg_pool2d, 3: F.avg_pool3d}[x.ndim]
        return pool(x[None, None], kernel_size=2 * r + 1, stride=1, padding=r,
                    count_include_pad=False)[0, 0]


def apply_filter_chain(x: torch.Tensor, filters: Sequence[Filter]) -> torch.Tensor:
    """Apply filters in order: design -> ... -> physical densities."""
    for f in filters:
        x = f.apply(x)
    return x
