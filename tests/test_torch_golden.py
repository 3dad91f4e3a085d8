"""The port's golden check: the 2-D MBB 300x100 float64 OC trace of
ndr_tpu_torch against the reference's committed run log
(``REFERENCE_TRACE``, as ``tests/test_golden.py`` holds ``ndr_tpu`` to
it), with the reference's multicolor Gauss-Seidel smoother, on the CPU.
Marked slow: opt in with ``-m slow``.
"""

import numpy as np
import pytest
import torch

from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.training.classic import ground_truth_topopt
from test_golden import REFERENCE_TRACE


@pytest.mark.slow
def test_port_mbb_300x100_oc_trace_matches_reference_log():
    cfg = load_problem("problems/2d/mbb_beam.json")
    result = ground_truth_topopt(
        cfg, max_iter=len(REFERENCE_TRACE) + 1, multigrid_levels=2,
        smoother="gs", dtype=torch.float64, device="cpu", log=lambda s: None,
    )
    # history[k] is the compliance before step k: the log's step-k objective
    ours = result.history[1:len(REFERENCE_TRACE) + 1]
    np.testing.assert_allclose(ours, REFERENCE_TRACE, rtol=2e-4)
