"""PyTorch runtime setup for solver workloads (counterpart of
``ndr_tpu/utils/jax_setup.py``).

The solvers need true fp32 contractions: a one-pass bf16 contraction gave
the Galerkin Ke a 1.2e-3 relative error and NaN'd the coarse Cholesky in
the JAX package, which is why it pins ``precision=HIGHEST``. On an NVIDIA
card the analogous hazard is TF32: cuDNN convolutions use it by default,
and matmuls do when ``allow_tf32`` is set. Both are switched off here.
"""

from __future__ import annotations

import torch


def setup() -> None:
    """Pin every float32 contraction to full fp32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(name: str = "cuda") -> torch.device:
    """The device the run asked for. Asking for CUDA on a machine without
    a usable card raises: the run never moves to the CPU on its own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run on the CPU")
    return device
