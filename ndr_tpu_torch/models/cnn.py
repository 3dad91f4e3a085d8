"""CNN density generators (counterpart of ``ndr_tpu/models/cnn.py``).

:class:`CNNGenerator` / :func:`cnn_apply`: the neural-structural-
optimization generator: latent vector -> dense -> reshape (C, h, w) ->
[tanh -> bilinear upsample -> global normalization -> SAME-padded 5x5
conv -> learned offset] per stage.

:class:`DeconvGenerator` / :func:`deconv_generator_apply`: the small
GAN-style deconv generator.

Parameters mirror the JAX trees (``dense.w``, ``convs.{i}.w``,
``offsets.{i}``, ``latent``; ``linear.w``, ``deconv1.w``, ...), so
``models.mlp.tree_state_dict`` carries JAX parameters across. The
bilinear upsampling is ``jax.image.resize(..., "bilinear")``, the port's
``ops.resize.resize`` (the evaluation's) with method "linear".
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ndr_tpu_torch.ops.resize import resize


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    grid_dims: Tuple[int, int] = (40, 20)
    latent_size: int = 128
    dense_channels: int = 32
    resizes: Sequence[int] = (1, 2, 2, 2, 1)
    conv_filters: Sequence[int] = (128, 64, 32, 16, 1)
    offset_scale: float = 10.0
    kernel_size: Tuple[int, int] = (5, 5)
    dense_init_scale: float = 1.0

    @property
    def base_hw(self):
        total = int(np.prod(self.resizes))
        return self.grid_dims[0] // total, self.grid_dims[1] // total


def _same_pad(h, w, kh, kw):
    """TensorFlow SAME padding amounts ((top, bottom), (left, right))."""
    ph, pw = max(kh - 1, 0), max(kw - 1, 0)
    return (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)


def _pdict(dtype, device, **shapes) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(torch.zeros(s, dtype=dtype, device=device))
                             for k, s in shapes.items()})


class CNNGenerator(nn.Module):
    def __init__(self, cfg: CNNConfig, dtype=torch.float32, device="cuda"):
        super().__init__()
        if len(cfg.resizes) != len(cfg.conv_filters):
            raise ValueError("resizes and filters must be same size")
        self.cfg = cfg
        h, w = cfg.base_hw
        n_dense = h * w * cfg.dense_channels
        self.dense = _pdict(dtype, device, w=(n_dense, cfg.latent_size), b=(n_dense,))
        kh, kw = cfg.kernel_size
        chans = [cfg.dense_channels] + list(cfg.conv_filters)
        self.convs = nn.ModuleList(_pdict(dtype, device, w=(o, i, kh, kw), b=(o,))
                                   for i, o in zip(chans[:-1], chans[1:]))
        shapes = []
        for r, out_ch in zip(cfg.resizes, cfg.conv_filters):
            h, w = h * r, w * r
            shapes.append((out_ch, h, w))
        self.offsets = nn.ParameterList(
            nn.Parameter(torch.zeros(s, dtype=dtype, device=device)) for s in shapes)
        self.latent = nn.Parameter(torch.zeros(cfg.latent_size, dtype=dtype, device=device))

    def forward(self, latent=None) -> torch.Tensor:
        return cnn_apply(self, latent)


def init_cnn(cfg: CNNConfig, generator: torch.Generator, dtype=torch.float32,
             device="cuda") -> CNNGenerator:
    """A :class:`CNNGenerator` with the JAX package's init: orthogonal dense
    weights with gain dense_init_scale * sqrt(max(n_dense / latent, 1)),
    He-normal (fan-in) convs, zero biases and offsets, an N(0, 1) latent;
    drawn on the CPU from ``generator``."""
    model = CNNGenerator(cfg, dtype=dtype, device=device)
    n_dense = model.dense["w"].shape[0]
    gain = cfg.dense_init_scale * float(np.sqrt(max(n_dense / cfg.latent_size, 1)))
    with torch.no_grad():
        w = torch.empty(model.dense["w"].shape, dtype=torch.float64)
        nn.init.orthogonal_(w, gain=gain, generator=generator)
        model.dense["w"].copy_(w)
        for conv in model.convs:
            out_ch, in_ch, kh, kw = conv["w"].shape
            std = float(np.sqrt(2.0 / (in_ch * kh * kw)))
            conv["w"].copy_(std * torch.randn(conv["w"].shape, generator=generator,
                                              dtype=torch.float64))
        model.latent.copy_(torch.randn(model.latent.shape, generator=generator,
                                       dtype=torch.float64))
    return model


def _global_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalize over every axis (unbiased variance, ddof=1)."""
    mean = torch.mean(x)
    var = torch.var(x, correction=1)
    return (x - mean) * torch.rsqrt(var + eps)


def _conv2d_same(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor, kernel_size):
    """x: (C_in, H, W); W: (C_out, C_in, kh, kw); TensorFlow SAME padding."""
    (pt, pb), (pl, pr) = _same_pad(x.shape[1], x.shape[2], *kernel_size)
    xp = F.pad(x, (pl, pr, pt, pb))
    return F.conv2d(xp[None], W)[0] + b[:, None, None]


def cnn_apply(model: CNNGenerator, latent=None) -> torch.Tensor:
    """latent (optional override of the trained one) -> density logits of
    shape grid_dims."""
    cfg = model.cfg
    z = model.latent if latent is None else latent
    x = z @ model.dense["w"].t() + model.dense["b"]
    h, w = cfg.base_hw
    x = x.reshape(cfg.dense_channels, h, w)
    for i, conv in enumerate(model.convs):
        x = torch.tanh(x)
        r = cfg.resizes[i]
        if r != 1:
            x = resize(x, (x.shape[0], x.shape[1] * r, x.shape[2] * r), method="linear")
        x = _global_normalize(x)
        x = _conv2d_same(x, conv["w"], conv["b"], cfg.kernel_size)
        if cfg.offset_scale != 0:
            x = x + cfg.offset_scale * model.offsets[i]
    return x[0]


# ---------------------------------------------------------------------------
# Deconv GAN-style generator
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeconvConfig:
    in_features: int = 1
    design: Tuple[int, int] = (180, 60)


class DeconvGenerator(nn.Module):
    """Linear (in -> 4), ConvTranspose2d(4 -> 2, k=7, pad=2, stride=2),
    ConvTranspose2d(2 -> 1, k=4, pad=2, stride=2); weights in torch's
    transposed-convolution layout (in, out, kh, kw)."""

    def __init__(self, cfg: DeconvConfig, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.linear = _pdict(dtype, device, w=(4, cfg.in_features), b=(4,))
        self.deconv1 = _pdict(dtype, device, w=(4, 2, 7, 7), b=(2,))
        self.deconv2 = _pdict(dtype, device, w=(2, 1, 4, 4), b=(1,))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return deconv_generator_apply(self, z)


def init_deconv_generator(cfg: DeconvConfig, generator: torch.Generator,
                          dtype=torch.float32, device="cuda") -> DeconvGenerator:
    """N(0, 0.02^2) weights, zero biases, drawn on the CPU from ``generator``."""
    model = DeconvGenerator(cfg, dtype=dtype, device=device)
    with torch.no_grad():
        for p in (model.linear["w"], model.deconv1["w"], model.deconv2["w"]):
            p.copy_(0.02 * torch.randn(p.shape, generator=generator, dtype=torch.float64))
    return model


def deconv_generator_apply(model: DeconvGenerator, z: torch.Tensor) -> torch.Tensor:
    """z: (latent, in_features), latent = design[0] * design[1] / 16 ->
    (design[0], design[1])."""
    cfg = model.cfg
    z = z.to(model.linear["w"].dtype)
    x = z @ model.linear["w"].t() + model.linear["b"]
    x = x.reshape(4, cfg.design[0] // 4, cfg.design[1] // 4)
    x = F.conv_transpose2d(x[None], model.deconv1["w"], model.deconv1["b"], stride=2,
                           padding=2)
    x = torch.tanh(F.conv_transpose2d(x, model.deconv2["w"], model.deconv2["b"],
                                      stride=2, padding=2))
    # fixed 3x3 average filter, zero padding
    kern = torch.full((1, 1, 3, 3), 1.0 / 9.0, dtype=x.dtype, device=x.device)
    return F.conv2d(F.pad(x, (1, 1, 1, 1)), kern)[0, 0]
