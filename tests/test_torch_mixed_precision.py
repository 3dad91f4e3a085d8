"""The mixed-precision envelope pins of tests/test_mixed_precision.py, on
ndr_tpu_torch.

The TO equilibrium systems are too ill-conditioned for pure fp32: the
fp32 apply's rounding exceeds the 1e-4 residual target, and K0 rounded to
fp32 loses the element's exact rigid-body null space. The port keeps K0
in float64 and refines the fp32 MGPCG in float64, and must recover the
float64 dense oracle's compliance, as the JAX package does. The oracle is
held to the JAX package's to rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.fem import solvers as jsolvers
from ndr_tpu.fem.simulator import problem_from_config as j_problem_from_config
from ndr_tpu.io.problem import load_problem as j_load_problem
from ndr_tpu_torch.fem import multigrid as mg
from ndr_tpu_torch.fem import solvers
from ndr_tpu_torch.fem.simulator import problem_from_config
from ndr_tpu_torch.io.problem import load_problem

MBB = "problems/2d/mbb_beam.json"
CANT = "problems/3d/cantilever_flexion.json"


def _oracle(path, dims, rho64):
    """The float64 dense-solve compliance of the port, checked against the
    JAX package's oracle to 1e-10: two Cholesky solves of an
    ill-conditioned K agree to about its condition number times the
    float64 rounding (1.5e-12 measured at 32x16)."""
    prob64, grid = problem_from_config(load_problem(path), dims=dims,
                                       dtype=torch.float64, device="cpu")
    u = solvers.dense_solve(prob64.young(torch.tensor(rho64)), prob64.K0,
                            prob64.dirichlet_mask, prob64.force, grid)
    c = float(torch.dot(prob64.force.reshape(-1), u.reshape(-1)))
    pj, _ = j_problem_from_config(j_load_problem(path), dims=dims, dtype=jnp.float64)
    uj = jsolvers.dense_solve(pj.young(jnp.asarray(rho64)), pj.K0, pj.dirichlet_mask,
                              pj.force, grid)
    assert c == pytest.approx(float(jnp.vdot(pj.force, uj)), rel=1e-10)
    return c


def _compliance(prob, u):
    return float(torch.dot(prob.force.reshape(-1).to(u.dtype), u.reshape(-1)))


def test_k0_kept_in_float64():
    prob32, _ = problem_from_config(load_problem(MBB), dims=(8, 4), dtype=torch.float32,
                                    device="cpu")
    assert prob32.K0.dtype == torch.float64
    assert prob32.force.dtype == torch.float32


def test_refined_solve_matches_f64_oracle():
    dims = (32, 16)
    rng = np.random.default_rng(0)
    rho64 = np.round(rng.uniform(0.1, 1.0, size=dims), 4)
    c_oracle = _oracle(MBB, dims, rho64)
    prob32, _ = problem_from_config(load_problem(MBB), dims=dims, dtype=torch.float32,
                                    device="cpu")
    rho32 = torch.tensor(rho64, dtype=torch.float32)
    kw = dict(num_levels=1, cg_iter=200, tol=1e-6)
    u_p, _ = mg.make_mg_solver(prob32, mg.MGSolverSettings(**kw, mixed_precision=False))(rho32)
    err_plain = abs(_compliance(prob32, u_p) - c_oracle) / c_oracle
    u_m, _ = mg.make_mg_solver(prob32, mg.MGSolverSettings(**kw, mixed_precision=True))(rho32)
    assert u_m.dtype == torch.float64
    err_mixed = abs(_compliance(prob32, u_m) - c_oracle) / c_oracle
    # rho's fp32 cast shifts the operator by ~1e-8: the refined compliance
    # lands within ~1e-5 of the oracle, far closer than the pure fp32 solve
    assert err_mixed < 3e-5, err_mixed
    assert err_mixed < err_plain / 10, (err_mixed, err_plain)


def test_refined_solve_chebyshev_smoother():
    dims = (8, 4, 4)
    c_oracle = _oracle(CANT, dims, np.full(dims, 0.5))
    prob32, _ = problem_from_config(load_problem(CANT), dims=dims, dtype=torch.float32,
                                    device="cpu")
    st = mg.MGSolverSettings(num_levels=1, cg_iter=200, tol=1e-7, mixed_precision=True,
                             smoother="chebyshev")
    u, _ = mg.make_mg_solver(prob32, st)(torch.full(dims, 0.5, dtype=torch.float32))
    assert abs(_compliance(prob32, u) - c_oracle) / c_oracle < 1e-5
