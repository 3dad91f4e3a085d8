"""Density filters, differentiable under autograd (counterpart of
``ndr_tpu/ops/filters.py``).

Two families:

1. Solver-side filters of the classic SIMP pipeline:
   :class:`ProjectionFilter`, :class:`SmoothingFilter`, the
   additive-manufacturing overhang filter :class:`LangelaarFilter`, and
   :class:`CallbackFilter` around any differentiable callable.
2. Training-side filters of the neural pipeline: tanh projection
   centered at 0, reflect-padded separable box and Gaussian blurs, and
   the :class:`AdaptiveFilterState` schedule.

All filters operate on density fields of shape ``grid.dims``; autograd
through the forward pass gives the reference's hand-written backprop.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
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


def _box_sum(x: torch.Tensor, r: int) -> torch.Tensor:
    """The sum over the in-bounds part of the radius-r cube around each
    cell. The zero padding is explicit: torch's pools refuse a window wider
    than the unpadded field (a radius-2 filter on a 4-cell axis)."""
    pool = {2: F.avg_pool2d, 3: F.avg_pool3d}[x.ndim]
    return pool(F.pad(x, (r, r) * x.ndim)[None, None], kernel_size=2 * r + 1, stride=1,
                divisor_override=1)[0, 0]


class _ClippedBoxMean(torch.autograd.Function):
    """y = (window sum of x) / (in-bounds count), and its transpose
    x_bar = window sum of (y_bar / count): the window is symmetric, so the
    backward is a pooling forward too. Pooling's own backward on CUDA
    adds the overlapping windows with atomics, in no fixed order; this one
    gathers, so a gradient is the same bits on every run."""

    @staticmethod
    def forward(ctx, x, r):
        ctx.r = r
        return _box_sum(x, r) / _box_sum(torch.ones_like(x), r)

    @staticmethod
    def backward(ctx, g):
        count = _box_sum(torch.ones_like(g), ctx.r)
        return _box_sum(g / count, ctx.r), None


@dataclasses.dataclass
class SmoothingFilter(Filter):
    """Cube-neighborhood mean with boundary-clipped stencils: each cell
    averages over the in-bounds part of the radius-r cube around it.

    The clipped window sum divided by the clipped count, both one
    ``avg_pool`` over the zero-padded field; the gradient is its transpose
    (:class:`_ClippedBoxMean`)."""

    radius: int = 1

    def apply(self, x):
        r = int(round(self.radius))
        if r <= 0:
            return x
        return _ClippedBoxMean.apply(x, r)


def _shifted(p: torch.Tensor, axis: int, step: int) -> torch.Tensor:
    """p moved by one along ``axis`` (``step`` -1: out[i] = p[i - 1];
    +1: out[i] = p[i + 1]), zero where that falls off the field."""
    n = p.shape[axis]
    zero = torch.zeros_like(p.narrow(axis, 0, 1))
    if step < 0:
        return torch.cat([zero, p.narrow(axis, 0, n - 1)], axis)
    return torch.cat([p.narrow(axis, 1, n - 1), zero], axis)


@dataclasses.dataclass
class LangelaarFilter(Filter):
    """Additive-manufacturing overhang filter (Langelaar 2017).

    Sweeps the layers along the LAST axis (the build direction): a voxel
    is no denser than a smooth minimum of its own value and a P-norm
    maximum of its supporting voxels in the printed layer below (directly
    below and its one-step neighbours in each other axis). A host loop over
    the layers, each a few elementwise ops on one layer; autograd through
    it gives the reference's hand-written backprop."""

    P: float = 40.0
    Q: float = 40.0 - 1.58
    epsilon: float = 1e-4

    def _smax_support(self, below: torch.Tensor) -> torch.Tensor:
        """P-norm 'max' over each voxel's supporting region in ``below``
        (the previous layer's printed densities, dims[:-1])."""
        p = torch.abs(below) ** self.P
        total = p
        for axis in range(below.ndim):
            total = total + _shifted(p, axis, -1) + _shifted(p, axis, 1)
        return total ** (1.0 / self.Q)

    def _smin(self, x1, x2):
        return 0.5 * (x1 + x2 - torch.sqrt((x1 - x2) ** 2 + self.epsilon)
                      + math.sqrt(self.epsilon))

    def apply(self, x):
        layers = torch.movedim(x, -1, 0)
        out = [layers[0]]
        for layer in layers[1:]:
            out.append(self._smin(layer, self._smax_support(out[-1])))
        return torch.movedim(torch.stack(out), 0, -1)


@dataclasses.dataclass
class CallbackFilter(Filter):
    """A filter around any differentiable callable ``fn`` (the reference's
    PythonFilter, which needs explicit apply and backprop callbacks; here
    autograd gives the backprop)."""

    fn: Callable = None

    def apply(self, x):
        return self.fn(x)


def apply_filter_chain(x: torch.Tensor, filters: Sequence[Filter]) -> torch.Tensor:
    """Apply filters in order: design -> ... -> physical densities."""
    for f in filters:
        x = f.apply(x)
    return x


# ---------------------------------------------------------------------------
# Training-side filters
# ---------------------------------------------------------------------------

def projection_filter(x, beta, normalized=False):
    """Tanh binarizer centered at 0."""
    if normalized:
        t = math.tanh(0.5 * beta)
        return 0.5 * (t + torch.tanh(beta * x)) / t
    return 0.5 * torch.tanh(beta * x) + 0.5


def _reflect_index(n: int, pad: int) -> np.ndarray:
    """Indices of a length-n axis padded by ``pad`` on each side in
    ``numpy.pad(mode="reflect")`` order (mirror without repeating the
    edge, folding again where pad >= n)."""
    i = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.mod(i, period)
    return np.where(i < n, i, period - i)


def _conv1d_along(x, kernel: torch.Tensor, axis: int):
    """'Same' correlation with reflect padding along one axis, summed
    tap by tap in the JAX package's order."""
    k = kernel.shape[0]
    n = x.shape[axis]
    idx = torch.as_tensor(_reflect_index(n, k // 2), device=x.device)
    xp = torch.index_select(x, axis, idx)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + kernel[i] * xp.narrow(axis, i, n)
    return out


def smoothing_filter(x, radius: int):
    """Normalized box blur with reflect padding (kornia.box_blur
    semantics), separable, 2-D and 3-D."""
    radius = int(round(radius))
    if radius <= 0:
        return x
    k = 2 * radius + 1
    kern = torch.full((k,), 1.0 / k, dtype=x.dtype, device=x.device)
    for axis in range(x.ndim):
        x = _conv1d_along(x, kern, axis)
    return x


def gaussian_kernel_1d(kernel_size: int, sigma: float, dtype, device) -> torch.Tensor:
    """Kornia-compatible normalized Gaussian window, of the filtered field's
    dtype and device."""
    xs = torch.arange(kernel_size, dtype=dtype, device=device) - kernel_size // 2
    g = torch.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def gaussian_kernel_size(sigma: float) -> int:
    """k = floor(6 sigma), forced odd."""
    k = int(np.floor(6 * sigma))
    if k % 2 == 0:
        k -= 1
    return max(k, 1)


def gaussian_filter(x, sigma: float, kernel_size: Optional[int] = None):
    """Gaussian blur with reflect padding."""
    k = kernel_size or gaussian_kernel_size(sigma)
    kern = gaussian_kernel_1d(k, sigma, dtype=x.dtype, device=x.device)
    for axis in range(x.ndim):
        x = _conv1d_along(x, kern, axis)
    return x


@dataclasses.dataclass
class AdaptiveFilterState:
    """Training-side filter parameters with their update schedules: the
    reference's (projection, smoothing, Gaussian) filter triple and its
    adaptive-filtering config."""

    use_projection: bool = False
    beta: float = 1.0
    beta_interval: float = 0.1
    beta_scaler: float = -1.0

    use_smoothing: bool = False
    radius: float = 1.0
    radius_interval: float = 0.1
    radius_scaler: float = -1.0

    use_gaussian: bool = False
    sigma: float = 1.0
    sigma_interval: float = 0.1
    sigma_scaler: float = -1.0

    def apply(self, x):
        """Apply the enabled filters with the current parameters, in the
        reference's order: projection -> smoothing -> Gaussian."""
        if self.use_projection:
            x = projection_filter(x, self.beta, normalized=True)
        if self.use_smoothing:
            x = smoothing_filter(x, int(self.radius))
        if self.use_gaussian:
            x = gaussian_filter(x, self.sigma,
                                kernel_size=gaussian_kernel_size(float(self.sigma)))
        return x

    def update(self, iteration: int):
        """Multiply parameters by their scalers every `interval` iterations."""
        if iteration == 0:
            return
        if self.use_projection and self.beta_interval >= 1 and iteration % int(self.beta_interval) == 0:
            self.beta *= self.beta_scaler
        if self.use_smoothing and self.radius_interval >= 1 and iteration % int(self.radius_interval) == 0:
            self.radius *= self.radius_scaler
        if self.use_gaussian and self.sigma_interval >= 1 and iteration % int(self.sigma_interval) == 0:
            self.sigma *= self.sigma_scaler

    def reset(self, beta=1.0, radius=1.0, sigma=1.0):
        self.beta, self.radius, self.sigma = beta, radius, sigma
