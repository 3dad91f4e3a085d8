"""Fourier-feature MLP, the neural design representation (counterpart of
``ndr_tpu/models/mlp.py``, single-head part).

  * Gaussian Fourier-feature embedding: ``B ~ N(0, 1) * sigma`` drawn once
    at init and not trained (a registered buffer, saved beside the
    weights).
  * encode(x) = [sin(2 pi x B^T), cos(2 pi x B^T)].
  * ``n_layers`` Linear layers (first 2*embed -> n_neurons, last -> out),
    ReLU hidden activations, optional sigmoid output.
  * orthogonal init with gain sqrt(max(n_neurons / embedding_size, 1)),
    zero biases.
  * :func:`homogeneous_init` re-initializes the last layer with tiny
    weights and bias = v_max, so step 0 predicts a uniform field at the
    target volume.

Matmul precision (``MLPConfig.matmul_precision``, JAX's names): "high"
and "highest" are true fp32 products (TF32 stays off, see
``utils/torch_setup.py``); "default" runs the layer products under a
bf16 autocast on the card (on the CPU it is fp32, as JAX's CPU backend
computes it). The Fourier encode is always full precision. The global
precision flags are never changed.

The multi-head / continual-learning parts of the JAX module are not
ported yet (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_features: int = 2
    out_features: int = 1
    n_neurons: int = 256
    n_layers: int = 4
    embedding_size: int = 256
    scale: float = 0.0                      # sigma of the Fourier features
    output_activation: Optional[str] = None  # None | "sigmoid"
    # hidden-layer matmul precision: "default" | "high" | "highest"
    matmul_precision: str = "high"


class FourierFeatureMLP(nn.Module):
    """The reference's ``networks.MLP``: frozen Fourier features + ReLU MLP.

    ``B`` is a buffer of shape (embedding_size, in_features); ``layers``
    hold weights of shape (out, in), the JAX package's layout.
    """

    def __init__(self, cfg: MLPConfig, dtype=torch.float32, device="cuda"):
        super().__init__()
        if cfg.matmul_precision not in ("default", "high", "highest"):
            raise ValueError(f"matmul_precision={cfg.matmul_precision!r}")
        self.cfg = cfg
        self.register_buffer(
            "B", torch.zeros(cfg.embedding_size, cfg.in_features, dtype=dtype,
                             device=device))
        sizes = ([2 * cfg.embedding_size] + [cfg.n_neurons] * (cfg.n_layers - 1)
                 + [cfg.out_features])
        self.layers = nn.ModuleList(
            nn.Linear(sizes[i], sizes[i + 1], dtype=dtype, device=device)
            for i in range(cfg.n_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self, x)


def init_mlp(cfg: MLPConfig, generator: torch.Generator, dtype=torch.float32,
             device="cuda") -> FourierFeatureMLP:
    """A :class:`FourierFeatureMLP` with B ~ N(0, 1) * scale, orthogonal
    weights and zero biases, drawn on the CPU from ``generator`` (so one
    seed gives the same network on every device)."""
    model = FourierFeatureMLP(cfg, dtype=dtype, device=device)
    gain = float(np.sqrt(max(cfg.n_neurons / cfg.embedding_size, 1.0)))
    with torch.no_grad():
        B = torch.randn(model.B.shape, generator=generator, dtype=torch.float64)
        model.B.copy_(B * cfg.scale)
        for lyr in model.layers:
            w = torch.empty(lyr.weight.shape, dtype=torch.float64)
            nn.init.orthogonal_(w, gain=gain, generator=generator)
            lyr.weight.copy_(w)
            lyr.bias.zero_()
    return model


def fourier_encode(x: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """[sin(2 pi x B^T), cos(2 pi x B^T)], in full precision."""
    proj = torch.matmul(2.0 * math.pi * x, B.t())
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def _layer_products(model: FourierFeatureMLP, h: torch.Tensor) -> torch.Tensor:
    layers = model.layers
    for i, lyr in enumerate(layers):
        h = torch.matmul(h, lyr.weight.t()) + lyr.bias
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def mlp_apply(model: FourierFeatureMLP, x: torch.Tensor) -> torch.Tensor:
    """Forward pass. x: (..., in_features) -> (..., out_features)."""
    cfg = model.cfg
    h = fourier_encode(x, model.B)
    if cfg.matmul_precision == "default" and h.device.type == "cuda":
        with torch.autocast("cuda", dtype=torch.bfloat16):
            h = _layer_products(model, h)
        h = h.to(x.dtype)
    else:
        h = _layer_products(model, h)
    if cfg.output_activation == "sigmoid":
        h = torch.sigmoid(h)
    return h


def mlp_apply_chunked(model: FourierFeatureMLP, x: torch.Tensor,
                      max_points: int = 1 << 17) -> torch.Tensor:
    """Memory-bounded forward pass over a large coordinate grid.

    The Fourier embedding materializes an (n, 2*embedding_size)
    activation (14.5 GB at 192x96x96 with 1024 features), so above
    ``max_points`` points the flattened coordinates go through in chunks,
    each under ``torch.utils.checkpoint``: the backward pass recomputes a
    chunk's activations instead of storing them all.
    """
    lead = x.shape[:-1]
    n = int(np.prod(lead))
    if n <= max_points:
        return mlp_apply(model, x)
    xf = x.reshape(n, x.shape[-1])
    outs = [checkpoint(mlp_apply, model, c, use_reentrant=False)
            for c in torch.split(xf, max_points)]
    return torch.cat(outs).reshape(lead + (model.cfg.out_features,))


def homogeneous_init(model: FourierFeatureMLP, constant: float) -> FourierFeatureMLP:
    """Last layer: weights N(0, 1e-4^2) from a fixed seed (they only break
    ties), bias = ``constant``, so the first field is uniform at the target
    volume. In place; returns the model."""
    last = model.layers[-1]
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        w = torch.randn(last.weight.shape, generator=gen, dtype=torch.float64)
        last.weight.copy_(1e-4 * w)
        last.bias.fill_(constant)
    return model


def params_from_jax(params, buffers) -> Dict[str, torch.Tensor]:
    """A :class:`FourierFeatureMLP` state dict from ``ndr_tpu`` MLP
    parameters and buffers (``{'layers': [{'w', 'b'}, ...]}``,
    ``{'B': ...}``) given as numpy-convertible arrays."""
    sd = {"B": torch.tensor(np.asarray(buffers["B"]))}
    for i, lyr in enumerate(params["layers"]):
        sd[f"layers.{i}.weight"] = torch.tensor(np.asarray(lyr["w"]))
        sd[f"layers.{i}.bias"] = torch.tensor(np.asarray(lyr["b"]))
    return sd
