"""Checkpoint save/load for neural-TO training (counterpart of
``ndr_tpu/utils/checkpoint.py``).

The file is the JAX package's format-2 ``.npz``, so a checkpoint written
by either package loads into the other. Leaves sit under their key
paths:

  * ``params/layers/{i}/w``, ``params/layers/{i}/b`` — layer weights
    (out, in) and biases;
  * ``buffers/B`` — the frozen Fourier matrix;
  * ``opt/0/count``, ``opt/0/mu/layers/{i}/{w,b}``,
    ``opt/0/nu/layers/{i}/{w,b}`` — optax Adam's state, which is torch
    Adam's ``step``, ``exp_avg`` and ``exp_avg_sq``;
  * ``meta`` — JSON bytes with ``scale``, ``step`` and ``format: 2``.

Restore checks the key set and every shape against the model and casts
to its dtype. The JAX package's older positional (format-1) files are
not read.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ndr_tpu_torch.models.mlp import FourierFeatureMLP


def _param_paths(model: FourierFeatureMLP) -> List[Tuple[str, torch.Tensor]]:
    out = []
    for i, lyr in enumerate(model.layers):
        out += [(f"layers/{i}/b", lyr.bias), (f"layers/{i}/w", lyr.weight)]
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()


def host_payload(model: FourierFeatureMLP, scale: float, step: Optional[int] = None,
                 optimizer: Optional[torch.optim.Optimizer] = None
                 ) -> Dict[str, np.ndarray]:
    """Every array of a checkpoint, copied to host memory, under its key."""
    payload = {f"params/{k}": _host(p) for k, p in _param_paths(model)}
    payload["buffers/B"] = _host(model.B)
    meta = {"scale": float(scale), "format": 2}
    if step is not None:
        meta["step"] = int(step)
    if optimizer is not None:
        count = 0
        for k, p in _param_paths(model):
            st = optimizer.state.get(p, {})
            if st:
                count = int(st["step"])
            zeros = torch.zeros(p.shape, dtype=p.dtype).numpy()
            payload[f"opt/0/mu/{k}"] = _host(st["exp_avg"]) if st else zeros
            payload[f"opt/0/nu/{k}"] = _host(st["exp_avg_sq"]) if st else zeros
        payload["opt/0/count"] = np.asarray(count, np.int32)
    payload["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    return payload


def _write(path: str, payload: Dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # atomic: a reader racing a periodic save never sees half a file
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, final)


def save_checkpoint(path: str, model: FourierFeatureMLP, scale: float,
                    step: Optional[int] = None,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Save a training checkpoint."""
    _write(path, host_payload(model, scale, step, optimizer))


class AsyncCheckpointer:
    """Checkpoint saves that write on a background thread.

    :meth:`save` copies every tensor to host memory first, so training may
    update the model as soon as it returns; only the ``.npz`` write runs
    on the thread. At most one write is in flight: a new save first waits
    for the previous one, which keeps the files in order. :meth:`wait`
    joins the write and raises its error, if any.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, path: str, model: FourierFeatureMLP, scale: float,
             step: Optional[int] = None,
             optimizer: Optional[torch.optim.Optimizer] = None) -> None:
        payload = host_payload(model, scale, step, optimizer)
        self.wait()

        def run():
            try:
                _write(path, payload)
            except Exception as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _restore(data, key: str, target: torch.Tensor) -> torch.Tensor:
    arr = data[key]
    if tuple(arr.shape) != tuple(target.shape):
        raise ValueError(f"checkpoint/{key}: shape {arr.shape} does not match "
                         f"{tuple(target.shape)}")
    return torch.as_tensor(arr).to(device=target.device, dtype=target.dtype)


def load_checkpoint(path: str, model: FourierFeatureMLP,
                    optimizer: Optional[torch.optim.Optimizer] = None
                    ) -> Tuple[float, Optional[int]]:
    """Restore weights, ``B`` and (when ``optimizer`` is given and the file
    has one) the Adam state into ``model`` / ``optimizer`` in place;
    returns (scale, step)."""
    paths = _param_paths(model)
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        if meta.get("format", 1) < 2:
            raise ValueError(f"{path}: positional (format-1) checkpoints are "
                             "not supported")
        want = {f"params/{k}" for k, _ in paths} | {"buffers/B"}
        stored = {k for k in data.files if k.startswith(("params/", "buffers/"))}
        if want != stored:
            raise ValueError(
                f"checkpoint structure mismatch: missing keys "
                f"{sorted(want - stored)[:5]}, unexpected keys "
                f"{sorted(stored - want)[:5]}")
        with torch.no_grad():
            for k, p in paths:
                p.copy_(_restore(data, f"params/{k}", p))
            model.B.copy_(_restore(data, "buffers/B", model.B))
        has_opt = any(k.startswith("opt/") for k in data.files)
        if optimizer is not None and has_opt:
            want = ({"opt/0/count"} | {f"opt/0/{m}/{k}" for k, _ in paths
                                       for m in ("mu", "nu")})
            stored = {k for k in data.files if k.startswith("opt/")}
            if want != stored:
                raise ValueError(
                    f"checkpoint optimizer state is not Adam's: missing keys "
                    f"{sorted(want - stored)[:5]}, unexpected keys "
                    f"{sorted(stored - want)[:5]}")
            count = float(data["opt/0/count"])
            on_device = optimizer.defaults.get("capturable") or optimizer.defaults.get("fused")
            for k, p in paths:
                optimizer.state[p] = {
                    "step": torch.tensor(count, dtype=torch.float32,
                                         device=p.device if on_device else "cpu"),
                    "exp_avg": _restore(data, f"opt/0/mu/{k}", p),
                    "exp_avg_sq": _restore(data, f"opt/0/nu/{k}", p),
                }
    return meta["scale"], meta.get("step")
