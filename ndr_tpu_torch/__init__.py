"""ndr_tpu_torch — the PyTorch/CUDA port of ``ndr_tpu``.

The package follows ``ndr_tpu``'s module layout and names, so each module
has a counterpart there. It imports ``torch`` and never ``jax``; the
NumPy-only modules of ``ndr_tpu`` (``grid``, ``fem.element``,
``io.problem``, ``io.export``, ``utils.history``) are imported, not copied.

  ndr_tpu_torch.fem       stiffness operators, hand-written CUDA kernels
                          (``fem.kernels``, sources in ``csrc/``),
                          multigrid, MGPCG, compliance and OC
  ndr_tpu_torch.ops       density filters and the volume constraint
  ndr_tpu_torch.training  the classic SIMP-OC driver and its CLI
  ndr_tpu_torch.utils     device/precision setup, timers
"""

__version__ = "0.1.0"
