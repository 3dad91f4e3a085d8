"""ndr_tpu_torch — the PyTorch/CUDA port of ``ndr_tpu``.

The package follows ``ndr_tpu``'s module layout and names, so each module
has a counterpart there. It imports ``torch`` and NumPy, never ``jax`` and
nothing of ``ndr_tpu``: the NumPy-only modules it needs (``grid``,
``fem.element``, ``io.problem``, ``io.export``) are its own copies.

  ndr_tpu_torch.grid      voxel-grid geometry and index conventions
  ndr_tpu_torch.io        problem/BC/material JSON, density export, the
                          native IO library (``io.native``)
  ndr_tpu_torch.fem       stiffness operators, hand-written CUDA kernels
                          (``fem.kernels``, sources in ``csrc/``),
                          multigrid, MGPCG, compliance and OC
  ndr_tpu_torch.models    the Fourier-feature MLP
  ndr_tpu_torch.ops       density filters, volume constraint and satisfiers
  ndr_tpu_torch.training  the classic SIMP-OC and neural-TO trainers, CLIs
  ndr_tpu_torch.eval      evaluation at a test resolution, its CLIs
  ndr_tpu_torch.utils     device/precision setup, timers, checkpoints,
                          plots
  ndr_tpu_torch.parallel  the sharded solver over torch.distributed ranks,
                          process groups and the multi-rank dry run
"""

__version__ = "0.2.0"
