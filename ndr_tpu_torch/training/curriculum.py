"""Multiresolution curriculum schedules (counterpart of the schedule part
of ``ndr_tpu/training/curriculum.py``; the continual-learning helpers are
not ported yet, ROADMAP.md Queue 1 item 12).

The random orders and sizes draw from an explicit NumPy generator.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


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
