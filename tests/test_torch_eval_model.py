"""``evaluate_model_at_resolution`` of ndr_tpu_torch vs ``ndr_tpu.eval``
(CPU, float64): the JAX network's weights carried into the port and
queried at the test resolution agree with JAX to rounding, held to 1e-9.
"""

import jax
import numpy as np
import pytest
import torch

from ndr_tpu import models as jmodels
from ndr_tpu.eval import evaluate as jeval
from ndr_tpu.io.problem import load_problem
from ndr_tpu_torch.eval import evaluate as teval
from ndr_tpu_torch.io.problem import load_problem as t_load_problem
from ndr_tpu_torch.models import mlp as tmlp

MBB = "problems/2d/mbb_beam.json"
RTOL = 1e-9


def _assert_same(rt, rj):
    for k in ("compliance", "binary_compliance", "binary_volume"):
        assert getattr(rt, k) == pytest.approx(getattr(rj, k), rel=RTOL, abs=0), k
    np.testing.assert_allclose(rt.density, np.asarray(rj.density), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dims,vcs", [((16, 8), "constrained_sigmoid"),
                                      ((24, 8), "maxed_barrier")])
def test_evaluate_model_at_resolution_matches_jax(dims, vcs):
    """The same network queried at the test resolution; a hard satisfier,
    and a soft one (sigmoid output, clipped)."""
    hard = vcs == "constrained_sigmoid"
    kw = dict(in_features=2, n_neurons=16, n_layers=2, embedding_size=8, scale=1.0,
              output_activation=None if hard else "sigmoid")
    jcfg = jmodels.MLPConfig(**kw)
    params, buffers = jmodels.init_mlp(jax.random.PRNGKey(0), jcfg)
    rj = jeval.evaluate_model_at_resolution(load_problem(MBB), params, buffers, jcfg, dims,
                                            volume_constraint_satisfier=vcs,
                                            multigrid_levels=1, tol=1e-7)
    model = tmlp.FourierFeatureMLP(tmlp.MLPConfig(**kw), dtype=torch.float32,
                                   device="cpu")
    model.load_state_dict(tmlp.params_from_jax(params, buffers))
    rt = teval.evaluate_model_at_resolution(t_load_problem(MBB), model, dims,
                                            volume_constraint_satisfier=vcs,
                                            multigrid_levels=1, tol=1e-7, device="cpu")
    assert rt.density.dtype == np.float64  # the network ran in the problem's dtype
    _assert_same(rt, rj)
