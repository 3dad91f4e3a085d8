"""Coordinate and latent inputs (counterpart of
``ndr_tpu/training/datasets.py``): plain tensor constructors, the
"dataset" being one deterministic batch (the coordinate grid or a latent
draw). Random draws come from an explicit ``torch.Generator`` (on the
CPU; the result moves to ``device``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ndr_tpu_torch.training.neural import get_mgrid


def mesh_grid(sidelen: Sequence[int], domain=None, flatten: bool = False,
              dtype=torch.float32, device="cuda") -> torch.Tensor:
    """``sidelen`` points per dim over ``domain`` ([0, 1]^N by default),
    sidelen + (N,), or (-1, N) with ``flatten``."""
    grid = get_mgrid(sidelen, domain=domain, dtype=dtype, device=device)
    if flatten:
        return grid.reshape(-1, grid.shape[-1])
    return grid


def supervised_mesh_grid(sidelen, gt_path: str, domain=None, dtype=torch.float32,
                         device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Coordinate grid + ground-truth densities loaded from .npy (stored
    as a negated transpose, which is undone)."""
    coords = mesh_grid(sidelen, domain=domain, dtype=dtype, device=device)
    gt = -np.load(gt_path).astype(np.float32).T
    return coords, torch.as_tensor(gt, dtype=dtype, device=device)


def random_field(generator: torch.Generator, latent: int, std: float = 0.1,
                 mean: float = 0.0, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """(latent, 1) normal draw, the deconv generator's input."""
    z = torch.randn((latent, 1), generator=generator, dtype=torch.float64)
    return (mean + std * z).to(dtype=dtype, device=device)


def normal_latent(generator: torch.Generator, latent_size: int, std: float = 1.0,
                  mean: float = 0.0, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """(latent_size,) normal draw, the CNN generator's latent vector."""
    z = torch.randn((latent_size,), generator=generator, dtype=torch.float64)
    return (mean + std * z).to(dtype=dtype, device=device)


def count_parameters(params) -> int:
    """Number of entries of a module's parameters, or of the tensors of a
    (nested) dict or sequence."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(count_parameters(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_parameters(v) for v in params)
    return int(np.prod(params.shape))
