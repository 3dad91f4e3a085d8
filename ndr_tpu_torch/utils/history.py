"""Optimization history recording + non-discreteness metric (the port's
copy of ``ndr_tpu/utils/history.py``, NumPy only).

(reference: VoxelFEM/python/helpers/history_helpers.py — per-iteration
density snapshots, objective trace, and the sharpness metric
``sum(4 rho (1-rho)) / N`` :57-62; subsampling keeps the final iterate.)
"""

from __future__ import annotations

import copy
from typing import List

import numpy as np


def nondiscreteness(density) -> float:
    """In [0,1]; solid/void voxels contribute zero
    (reference: history_helpers.py:57-62)."""
    d = np.asarray(density)
    return float(np.sum(4.0 * d * (1.0 - d)) / d.size)


class OptimizationHistory:
    """(reference: history_helpers.optimizationHistory)"""

    def __init__(self):
        self.recorded_epochs = 0
        self.density: List[np.ndarray] = []
        self.iter: List[int] = []
        self.objective: List[float] = []
        self.nondiscreteness: List[float] = []

    def update(self, x, obj):
        self.recorded_epochs += 1
        self.density.append(np.asarray(x))
        self.iter.append(self.recorded_epochs)
        self.objective.append(float(obj))
        self.nondiscreteness.append(nondiscreteness(self.density[-1]))

    def subsample(self, period: int) -> "OptimizationHistory":
        out = copy.deepcopy(self)
        sampler = list(range(0, self.recorded_epochs, period))
        if sampler and sampler[-1] != self.recorded_epochs - 1:
            sampler.append(self.recorded_epochs - 1)
        out.density = [self.density[i] for i in sampler]
        out.iter = [self.iter[i] for i in sampler]
        out.objective = [self.objective[i] for i in sampler]
        out.nondiscreteness = [self.nondiscreteness[i] for i in sampler]
        out.recorded_epochs = len(out.density)
        return out


def upscale_scalar_field(dims, x):
    """Double every dimension by nearest-neighbor replication
    (reference: multiscale_helpers.upscaleScalarField)."""
    field = np.asarray(x).reshape(dims)
    for ax in range(len(dims)):
        field = np.repeat(field, 2, axis=ax)
    return tuple(field.shape), field.reshape(-1)


def downscale_scalar_field(dims, x):
    """Halve every dimension by stride-2 subsampling
    (reference: multiscale_helpers.downscaleScalarField)."""
    field = np.asarray(x).reshape(dims)
    slicer = tuple(slice(0, None, 2) for _ in dims)
    field = field[slicer]
    return tuple(field.shape), field.reshape(-1)


def numerical_derivative(F, x, h, direction):
    """Second-order centered differences
    (reference: debug_helpers.numericalDerivative)."""
    return (F(x + h * direction) - F(x - h * direction)) / (2.0 * h)
