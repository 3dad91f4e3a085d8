"""Volume constraint (counterpart of ``ndr_tpu/ops/volume.py``'s
classic-path part)."""

from __future__ import annotations

import torch


def total_volume_constraint(rho: torch.Tensor, max_volume: float) -> torch.Tensor:
    """c = 1 - mean(rho) / v_max  (>= 0 feasible, 0 when active)."""
    return 1.0 - torch.mean(rho) / max_volume
