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
  * :class:`MultiHeadMLP`, the continual-learning variant: a shared trunk
    (the MLP's layers but the last) and one linear head per task, with
    optional per-task activation masks on the trunk and an ``old_scale``
    buffer for rescaling B to a new task's sigma
    (:func:`change_scale_value`).

Matmul precision (``MLPConfig.matmul_precision``, JAX's names): "high"
and "highest" are true fp32 products (TF32 stays off, see
``utils/torch_setup.py``); "default" runs the layer products under a
bf16 autocast on the card (on the CPU it is fp32, as JAX's CPU backend
computes it). The Fourier encode is always full precision. The global
precision flags are never changed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence

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


def _layer_products(layers: Sequence[nn.Linear], h: torch.Tensor,
                    activation_masks=None, relu_last: bool = False) -> torch.Tensor:
    """The layers' products, ReLU after all but the last (after every one
    with ``relu_last``), each hidden output multiplied by its keep mask
    first where ``activation_masks`` are given."""
    for i, lyr in enumerate(layers):
        h = torch.matmul(h, lyr.weight.t()) + lyr.bias
        if relu_last or i < len(layers) - 1:
            if activation_masks is not None:
                h = h * activation_masks[i].to(h.dtype)
            h = torch.relu(h)
    return h


def _products(cfg: MLPConfig, x: torch.Tensor, h: torch.Tensor, fn) -> torch.Tensor:
    """``fn(h)``, under a bf16 autocast on the card for matmul_precision
    "default", returned in x's dtype."""
    if cfg.matmul_precision == "default" and h.device.type == "cuda":
        with torch.autocast("cuda", dtype=torch.bfloat16):
            h = fn(h)
        return h.to(x.dtype)
    return fn(h)


def mlp_apply(model: FourierFeatureMLP, x: torch.Tensor,
              activation_masks=None) -> torch.Tensor:
    """Forward pass. x: (..., in_features) -> (..., out_features).
    ``activation_masks``: one keep mask per hidden layer output (the
    continual-learning gated activations, fixed per task)."""
    cfg = model.cfg
    h = _products(cfg, x, fourier_encode(x, model.B),
                  lambda h: _layer_products(model.layers, h, activation_masks))
    if cfg.output_activation == "sigmoid":
        h = torch.sigmoid(h)
    return h


def apply_chunked(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                  out_features: int, max_points: int = 1 << 17) -> torch.Tensor:
    """Memory-bounded ``fn(x)`` over a large coordinate grid.

    The Fourier embedding materializes an (n, 2*embedding_size)
    activation (14.5 GB at 192x96x96 with 1024 features), so above
    ``max_points`` points the flattened coordinates go through in chunks,
    each under ``torch.utils.checkpoint``: the backward pass recomputes a
    chunk's activations instead of storing them all. Each output row
    depends on its own input row only, so the result is ``fn(x)``'s.
    """
    lead = x.shape[:-1]
    n = int(np.prod(lead))
    if n <= max_points:
        return fn(x)
    xf = x.reshape(n, x.shape[-1])
    outs = [checkpoint(fn, c, use_reentrant=False) for c in torch.split(xf, max_points)]
    return torch.cat(outs).reshape(lead + (out_features,))


def mlp_apply_chunked(model: FourierFeatureMLP, x: torch.Tensor,
                      max_points: int = 1 << 17) -> torch.Tensor:
    """:func:`mlp_apply` through :func:`apply_chunked`."""
    return apply_chunked(lambda c: mlp_apply(model, c), x, model.cfg.out_features,
                         max_points)


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


# ---------------------------------------------------------------------------
# Multi-headed MLP (continual learning)
# ---------------------------------------------------------------------------

class MultiHeadMLP(nn.Module):
    """Shared trunk (the MLP of ``cfg`` less its last layer) + one linear
    head (n_neurons -> out_features) per task. Buffers: ``B``
    (embedding_size, in_features) and ``old_scale`` (the sigma B is scaled
    to)."""

    def __init__(self, cfg: MLPConfig, n_heads: int, dtype=torch.float32, device="cuda"):
        super().__init__()
        if cfg.matmul_precision not in ("default", "high", "highest"):
            raise ValueError(f"matmul_precision={cfg.matmul_precision!r}")
        self.cfg = cfg
        self.register_buffer(
            "B", torch.zeros(cfg.embedding_size, cfg.in_features, dtype=dtype,
                             device=device))
        self.register_buffer("old_scale", torch.ones((), dtype=dtype, device=device))
        sizes = [2 * cfg.embedding_size] + [cfg.n_neurons] * (cfg.n_layers - 1)
        self.trunk = nn.ModuleList(
            nn.Linear(sizes[i], sizes[i + 1], dtype=dtype, device=device)
            for i in range(cfg.n_layers - 1))
        self.heads = nn.ModuleList(
            nn.Linear(cfg.n_neurons, cfg.out_features, dtype=dtype, device=device)
            for _ in range(n_heads))


def init_multihead_mlp(cfg: MLPConfig, n_heads: int, generator: torch.Generator,
                       dtype=torch.float32, device="cuda") -> MultiHeadMLP:
    """A :class:`MultiHeadMLP` with the JAX package's init: B ~ N(0, 1)
    (the trunk's scale is 1; :func:`change_scale_value` sets a task's
    sigma), orthogonal trunk and head weights with gain
    sqrt(max(n_neurons / embedding_size, 1)), zero biases, ``old_scale``
    1; drawn on the CPU from ``generator``."""
    model = MultiHeadMLP(cfg, n_heads, dtype=dtype, device=device)
    gain = float(np.sqrt(max(cfg.n_neurons / cfg.embedding_size, 1.0)))
    with torch.no_grad():
        model.B.copy_(torch.randn(model.B.shape, generator=generator,
                                  dtype=torch.float64))
        for lyr in list(model.trunk) + list(model.heads):
            w = torch.empty(lyr.weight.shape, dtype=torch.float64)
            nn.init.orthogonal_(w, gain=gain, generator=generator)
            lyr.weight.copy_(w)
            lyr.bias.zero_()
    return model


def multihead_apply(model: MultiHeadMLP, x: torch.Tensor, head_idx: int,
                    activation_masks=None) -> torch.Tensor:
    """Shared trunk + head ``head_idx``: x (..., in_features) ->
    (..., out_features). ``activation_masks`` (one keep mask per trunk
    layer output) gate the trunk's units for a task."""
    head = model.heads[head_idx]

    def fn(h):
        h = _layer_products(model.trunk, h, activation_masks, relu_last=True)
        return torch.matmul(h, head.weight.t()) + head.bias

    return _products(model.cfg, x, fourier_encode(x, model.B), fn)


def change_scale_value(model: MultiHeadMLP, scale: float) -> MultiHeadMLP:
    """Rescale B for a new task's sigma: B / old_scale * scale, and
    old_scale = scale. In place; returns the model."""
    with torch.no_grad():
        model.B.copy_(model.B / model.old_scale * scale)
        model.old_scale.fill_(scale)
    return model


def params_from_jax(params, buffers) -> Dict[str, torch.Tensor]:
    """A state dict from ``ndr_tpu`` MLP parameters and buffers given as
    numpy-convertible arrays: ``{'layers': [{'w', 'b'}, ...]}`` and
    ``{'B'}`` for a :class:`FourierFeatureMLP`, ``{'trunk': [...],
    'heads': [...]}`` and ``{'B', 'old_scale'}`` for a
    :class:`MultiHeadMLP`."""
    sd = {name: torch.tensor(np.asarray(buffers[name]))
          for name in ("B", "old_scale") if name in buffers}
    for group in ("layers", "trunk", "heads"):
        for i, lyr in enumerate(params.get(group, ())):
            sd[f"{group}.{i}.weight"] = torch.tensor(np.asarray(lyr["w"]))
            sd[f"{group}.{i}.bias"] = torch.tensor(np.asarray(lyr["b"]))
    return sd


def tree_state_dict(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX parameter tree (nested dicts and lists of numpy-convertible
    arrays) as a flat state dict, keys joined by "." (dict keys and list
    indices): the state dict of a module whose parameters mirror the tree
    (the SIREN and CNN modules)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: torch.tensor(np.asarray(tree))}
    out = {}
    for k, v in items:
        out.update(tree_state_dict(v, f"{prefix}{k}."))
    return out
