"""Fourier-feature interpolation studies (counterpart of
``ndr_tpu/eval/fourfeat_utils.py``).

  * :func:`compare_interpolation` — fit an FF-MLP to a subsampled image
    with Adam, query it at the full resolution and compare its PSNR with
    nearest, linear and cubic upsampling (:func:`evaluate.resize`).
  * :func:`interpolate_coarse_to_fine` — linearly upsample a coarse
    density field and re-evaluate its compliance at the finer grid.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ndr_tpu_torch.eval.evaluate import evaluate_density, resize, upsample_density
from ndr_tpu_torch.io.problem import ProblemConfig
from ndr_tpu_torch.models import mlp
from ndr_tpu_torch.training.neural import get_mgrid


def mse(y1: torch.Tensor, y2: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.mean((y1 - y2) ** 2)


def psnr(y1: torch.Tensor, y2: torch.Tensor) -> torch.Tensor:
    """-10 log10(2 mse)."""
    return -10.0 * torch.log10(2.0 * mse(y1, y2))


def compare_interpolation(
    image: np.ndarray,
    scale_factor: int = 2,
    sigma: float = 10.0,
    steps: int = 2000,
    lr: float = 1e-4,
    model: Optional[mlp.FourierFeatureMLP] = None,
    device="cuda",
    log=lambda s: sys.stderr.write(s),
) -> Dict[str, float]:
    """Fit an FF-MLP (256/256x4, Fourier scale ``sigma``, sigmoid output;
    ``model`` if given, else drawn from seed 0) to the image subsampled by
    ``scale_factor``, query it at full resolution, and return the PSNR of
    it and of the classical upsamplings: {"fourfeat", "nearest", "linear",
    "cubic"}. The network trains in its own dtype."""
    img = torch.as_tensor(np.asarray(image), dtype=torch.float32, device=device)
    if img.ndim == 2:
        img = img[..., None]
    coarse = img[::scale_factor, ::scale_factor]
    if model is None:
        cfg = mlp.MLPConfig(in_features=2, out_features=img.shape[-1], n_neurons=256,
                            n_layers=4, embedding_size=256, scale=sigma,
                            output_activation="sigmoid")
        model = mlp.init_mlp(cfg, torch.Generator().manual_seed(0), device=device)
    dt = model.B.dtype
    coords = get_mgrid(coarse.shape[:2], device=device).to(dt)
    target = coarse.to(dt)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    for i in range(steps):
        opt.zero_grad()
        loss = mse(mlp.mlp_apply(model, coords), target)
        loss.backward()
        opt.step()
        if i % max(steps // 10, 1) == 0:
            log(f"fourfeat fit step {i}: loss {loss.item():.3e}\n")

    with torch.no_grad():
        pred = mlp.mlp_apply(model, get_mgrid(img.shape[:2], device=device).to(dt))
        results = {"fourfeat": float(psnr(pred, img.to(dt)))}
        for mode in ("nearest", "linear", "cubic"):
            results[mode] = float(psnr(resize(coarse, img.shape, method=mode), img))
    for k, v in results.items():
        log(f"{k}: psnr {v:.3f}\n")
    return results


def interpolate_coarse_to_fine(
    coarse_density,
    cfg: ProblemConfig,
    size: Sequence[int],
    device="cuda",
    log=lambda s: sys.stderr.write(s),
):
    """Upsample a coarse density field and re-evaluate its compliance and
    binary compliance at the finer resolution."""
    fine = upsample_density(torch.as_tensor(np.asarray(coarse_density)), tuple(size))
    result = evaluate_density(cfg, fine.numpy(), dims=tuple(size), device=device)
    log(f"bilinear | Compliance after interpolation to {list(size)}: "
        f"{result.compliance}\n")
    return result
