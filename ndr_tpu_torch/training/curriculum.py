"""Multiresolution and continual-learning curriculum utilities
(counterpart of ``ndr_tpu/training/curriculum.py``).

The resolution schedules draw their random orders and sizes from an
explicit NumPy generator, the continual-learning helpers from an explicit
``torch.Generator`` (on the CPU; the results move to the parameters'
device).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn


def prepare_resolutions(interval=5, start=0, end=10, order="ctf", repeat_res=1,
                        generator: Optional[np.random.Generator] = None):
    """Array of resolution *deltas* added to a base grid size: 'ctf'
    appends a repeat of the final entry, 'ftc' negates and appends 0,
    'random' shuffles with ``generator``."""
    resolutions = np.arange(start=start, stop=end) * interval
    resolutions = np.concatenate(tuple([resolutions] * repeat_res))
    if order == "ctf":
        return np.concatenate([resolutions, np.array([resolutions[-1]])])
    if order == "ftc":
        return -np.concatenate([resolutions, np.array([0])])
    if order == "random":
        (generator or np.random.default_rng()).shuffle(resolutions)
        return resolutions
    raise NotImplementedError(f"order {order!r} does not exist or is WIP")


def prepare_epoch_sizes(n_resolutions, start=500, end=2000, mode="constant",
                        constant_value=1500,
                        generator: Optional[np.random.Generator] = None) -> List[int]:
    """Iterations per resolution; 'random' draws from ``generator``."""
    if mode == "constant":
        return [constant_value] * n_resolutions
    if mode == "linear_inc":
        return list(np.linspace(start, end, n_resolutions).astype(int))
    if mode == "linear_dec":
        return list(np.linspace(end, start, n_resolutions).astype(int))
    if mode == "linear_abs":
        dec = list(np.linspace(end, start, n_resolutions).astype(int))
        inc = list(np.linspace(start, end, n_resolutions).astype(int))
        if n_resolutions % 2 != 0:
            return list(np.concatenate([dec[::2], inc[:-2:2]]))
        return list(np.concatenate([dec[::2], inc[::2]]))
    if mode == "random":
        rng = generator or np.random.default_rng()
        return list(rng.uniform(start, end, size=(n_resolutions,)).astype(int))
    raise NotImplementedError(f"mode {mode!r} does not exist")


def prepare_task_values(interval=5, start=0, end=10, order="ctf",
                        generator: Optional[torch.Generator] = None):
    """Sigma deltas of the continual-learning tasks: 'ctf' ascending,
    'ftc' negated, 'random' shuffled with ``generator``."""
    task_values = np.arange(start=start, stop=end) * interval
    if order == "ctf":
        return task_values
    if order == "ftc":
        return -task_values
    if order == "random":
        return task_values[torch.randperm(len(task_values), generator=generator).numpy()]
    raise NotImplementedError(f"order {order!r} does not exist or is WIP")


def _leaves(params):
    """The tensors of a module (its parameters) or of a sequence of them."""
    if isinstance(params, nn.Module):
        return list(params.parameters())
    return list(params)


def forget_weights(generator: torch.Generator, params, rate, mode="orthogonal", mean=0.0,
                   std=0.1, lb=-1.0, ub=1.0, n_neurons=256, embedding_size=256,
                   constant_value=1e-2):
    """Re-draw weights at random positions of every parameter of ``params``
    (a module, e.g. a trunk, or a sequence of tensors), in place.

    The JAX package's rule, kept as it is: where ``uniform > rate`` a
    weight matrix takes the new value drawn per ``mode`` ("orthogonal",
    "normal", "uniform", "constant") and a 1-D parameter (a bias) is set
    to zero; so a weight is replaced with probability 1 - rate. Returns
    ``params``."""
    gain = float(np.sqrt(max(n_neurons / embedding_size, 1)))
    with torch.no_grad():
        for w in _leaves(params):
            mask = torch.rand(w.shape, generator=generator, dtype=torch.float64) > rate
            if w.dim() > 1:
                if mode == "orthogonal":
                    new = torch.empty(w.shape, dtype=torch.float64)
                    nn.init.orthogonal_(new, gain=gain, generator=generator)
                elif mode == "normal":
                    new = mean + std * torch.randn(w.shape, generator=generator,
                                                   dtype=torch.float64)
                elif mode == "uniform":
                    new = lb + (ub - lb) * torch.rand(w.shape, generator=generator,
                                                      dtype=torch.float64)
                elif mode == "constant":
                    new = torch.full(w.shape, constant_value, dtype=torch.float64)
                else:
                    raise NotImplementedError(f"mode {mode!r}")
            else:
                new = torch.zeros(w.shape, dtype=torch.float64)
            mask, new = mask.to(w.device), new.to(device=w.device, dtype=w.dtype)
            w.copy_(torch.where(mask, new, w))
    return params


def make_activation_masks(generator: torch.Generator, layers, rate) -> List[torch.Tensor]:
    """Keep masks of the continual-learning gated activations, drawn once
    per task: one per hidden layer output, ``uniform > rate`` (a unit is
    zeroed with probability ``rate``). ``layers``: a
    :class:`~ndr_tpu_torch.models.mlp.MultiHeadMLP` (its trunk), a
    :class:`~ndr_tpu_torch.models.mlp.FourierFeatureMLP` (all layers but
    the output) or a sequence of ``nn.Linear``."""
    if hasattr(layers, "trunk"):
        layers = layers.trunk
    elif hasattr(layers, "layers"):
        layers = layers.layers[:-1]
    return [(torch.rand(lyr.weight.shape[0], generator=generator, dtype=torch.float64)
             > rate).to(lyr.weight.device) for lyr in layers]
