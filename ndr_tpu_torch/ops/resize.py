"""``jax.image.resize`` for "nearest", "linear" and "cubic": half-pixel
centres, per-axis weight matrices renormalized at the edges and, when
shrinking, a kernel widened by the scale (antialiasing). Its "cubic" is
Keys' kernel with a = -0.5. Used by the evaluation (``eval/evaluate.py``,
which re-exports :func:`resize`) and the CNN generator's bilinear
upsampling.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def _resize_weights(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(in_size, out_size) float64 weights of one axis of :func:`resize`
    ("linear" or "cubic")."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)      # widen the kernel when shrinking
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size)[:, None]) / kernel_scale
    w = _KERNELS[method](x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    # fp32 arithmetic, as jax.image.resize computes it
    f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(in_size) / np.float32(out_size)
    return np.floor(f).astype(np.int64)


def resize(x: torch.Tensor, shape: Sequence[int], method: str = "linear") -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for "nearest", "linear" and
    "cubic" (antialiased when shrinking): every axis whose size changes is
    resampled, one axis at a time."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} does not match {tuple(x.shape)}")
    if method not in ("nearest", "linear", "cubic"):
        raise ValueError(f"unknown resize method {method!r}")
    if method != "nearest" and not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        if method == "nearest":
            idx = torch.as_tensor(_nearest_index(m, n), device=x.device)
            x = x.index_select(d, idx)
        else:
            w = torch.as_tensor(_resize_weights(m, n, method), dtype=x.dtype,
                                device=x.device)
            x = torch.tensordot(x, w, dims=([d], [0])).movedim(-1, d)
    return x
