"""SIREN: sinusoidal representation network (counterpart of
``ndr_tpu/models/siren.py``).

First-layer weights U(-1/in, 1/in), hidden and final weights
U(-sqrt(6/in)/w0, sqrt(6/in)/w0), biases U(-1/sqrt(in), 1/sqrt(in)) (torch
``Linear``'s default); activation sin(w0 (Wx + b)), optional final linear
layer. Parameters mirror the JAX tree: ``layers.{i}.w`` / ``.b``, weights
(out, in).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class SirenConfig:
    in_features: int = 2
    hidden_features: int = 256
    hidden_layers: int = 3
    out_features: int = 1
    outermost_linear: bool = True
    first_omega_0: float = 30.0
    hidden_omega_0: float = 30.0


def _sizes(cfg: SirenConfig):
    """(fan_in, fan_out) of each layer, the final one last."""
    sizes = [cfg.in_features] + [cfg.hidden_features] * (cfg.hidden_layers + 1)
    return ([(sizes[i], sizes[i + 1]) for i in range(cfg.hidden_layers + 1)]
            + [(cfg.hidden_features, cfg.out_features)])


class Siren(nn.Module):
    def __init__(self, cfg: SirenConfig, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            nn.ParameterDict({
                "w": nn.Parameter(torch.zeros(fan_out, fan_in, dtype=dtype, device=device)),
                "b": nn.Parameter(torch.zeros(fan_out, dtype=dtype, device=device))})
            for fan_in, fan_out in _sizes(cfg))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return siren_apply(self, x)


def init_siren(cfg: SirenConfig, generator: torch.Generator, dtype=torch.float32,
               device="cuda") -> Siren:
    """A :class:`Siren` with the reference's init bounds, drawn on the CPU
    from ``generator``."""
    model = Siren(cfg, dtype=dtype, device=device)

    def uniform(p, bound):
        u = torch.rand(p.shape, generator=generator, dtype=torch.float64)
        p.copy_((2.0 * u - 1.0) * bound)

    with torch.no_grad():
        for i, (lyr, (fan_in, _)) in enumerate(zip(model.layers, _sizes(cfg))):
            bound = 1.0 / fan_in if i == 0 else np.sqrt(6.0 / fan_in) / cfg.hidden_omega_0
            uniform(lyr["w"], bound)
            uniform(lyr["b"], 1.0 / np.sqrt(fan_in))
    return model


def siren_apply(model: Siren, x: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    h = x
    last = len(model.layers) - 1
    for i, lyr in enumerate(model.layers):
        pre = h @ lyr["w"].t() + lyr["b"]
        if i == last and cfg.outermost_linear:
            h = pre
        else:
            w0 = cfg.first_omega_0 if i == 0 else cfg.hidden_omega_0
            h = torch.sin(w0 * pre)
    return h
