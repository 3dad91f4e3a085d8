"""MGPCG with the multicolor Gauss-Seidel smoother and the dense oracles
of ndr_tpu_torch vs the JAX package (float64, CPU).

The JAX GS solve compiles for ~10 s in 2-D and ~60-115 s in 3-D on the
CPU, so the solves held to JAX run on the 2-D MBB beam; the 3-D solves
are held to the port's dense Cholesky oracle. Measured: solutions within
1e-12 of JAX with equal CG counts, held to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.fem import multigrid as jmg
from ndr_tpu.fem import operators as jops
from ndr_tpu.fem import solvers as jsolvers
from ndr_tpu.fem.simulator import problem_from_config as j_problem_from_config
from ndr_tpu.io.problem import load_problem
from ndr_tpu_torch.fem import multigrid as tmg
from ndr_tpu_torch.fem import operators as tops
from ndr_tpu_torch.fem import solvers as tsolvers
from ndr_tpu_torch.fem.simulator import problem_from_config as t_problem_from_config
from ndr_tpu_torch.io.problem import load_problem as t_load_problem

MBB = "problems/2d/mbb_beam.json"
CANT = "problems/3d/cantilever_flexion.json"
TOL = 1e-10


def _rel(out, ref) -> float:
    out = out.double().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _problems(prob_path, dims):
    pj, grid = j_problem_from_config(load_problem(prob_path), dims=dims,
                                     dtype=jnp.float64)
    pt, _ = t_problem_from_config(t_load_problem(prob_path), dims=dims,
                                  dtype=torch.float64, device="cpu")
    return pj, pt, grid


def _dense(pt, rho):
    return tsolvers.dense_solve(pt.young(torch.tensor(rho)), pt.K0, pt.dirichlet_mask,
                                pt.force, pt.grid)


@pytest.mark.parametrize("fmg,mg_iterations", [(True, 1), (False, 2)],
                         ids=["fmg-1", "vcycle-2"])
def test_gs_mgpcg_matches_jax(fmg, mg_iterations):
    pj, pt, grid = _problems(MBB, (24, 8))
    rho = np.random.default_rng(0).uniform(0.05, 1.0, grid.dims)
    kw = dict(num_levels=2, tol=1e-10, full_multigrid=fmg, mg_iterations=mg_iterations)
    sj = jmg.make_mg_solver(pj, jmg.MGSolverSettings(**kw))
    uj, itj = jax.jit(lambda r: sj(r, None))(jnp.asarray(rho))
    st = tmg.make_mg_solver(pt, tmg.MGSolverSettings(**kw))
    assert st.settings.smoother == "gs"      # the default, as in JAX
    ut, itt = st(torch.tensor(rho))
    assert itt == int(itj)
    assert _rel(ut, uj) < TOL
    assert _rel(ut, _dense(pt, rho)) < 1e-9


@pytest.mark.parametrize("fmg,mg_iterations", [(True, 1), (True, 2), (False, 1), (False, 2)],
                         ids=["fmg-1", "fmg-2", "vcycle-1", "vcycle-2"])
@pytest.mark.parametrize("prob_path,dims,nl", [(MBB, (12, 6), 1), (CANT, (8, 4, 4), 2)],
                         ids=["mbb12x6", "cantilever8x4x4"])
def test_gs_mgpcg_matches_dense_solve(prob_path, dims, nl, fmg, mg_iterations):
    _, pt, grid = _problems(prob_path, dims)
    rho = np.random.default_rng(1).uniform(0.05, 1.0, grid.dims)
    st = tmg.make_mg_solver(pt, tmg.MGSolverSettings(
        num_levels=nl, tol=1e-10, full_multigrid=fmg, mg_iterations=mg_iterations))
    ut, iters = st(torch.tensor(rho))
    assert iters < 100
    assert _rel(ut, _dense(pt, rho)) < 1e-8


def test_dense_oracles_match_jax():
    pj, pt, grid = _problems(CANT, (4, 2, 2))
    rng = np.random.default_rng(2)
    young = np.asarray(pj.young(jnp.asarray(rng.uniform(0.05, 1.0, grid.dims))))
    K0 = np.asarray(pj.K0)
    np.testing.assert_allclose(tops.assemble_dense_k(young, K0, pt.grid),
                               jops.assemble_dense_k(young, K0, grid), rtol=0, atol=1e-13)
    np.testing.assert_array_equal(
        tsolvers.dense_pinned_matrix(young, K0, pt.dirichlet_mask.numpy(), pt.grid),
        jsolvers.dense_pinned_matrix(young, K0, np.asarray(pj.dirichlet_mask), grid))
    ref = jsolvers.dense_solve(jnp.asarray(young), pj.K0, pj.dirichlet_mask, pj.force, grid)
    out = tsolvers.dense_solve(torch.tensor(young), pt.K0, pt.dirichlet_mask, pt.force,
                               pt.grid)
    assert _rel(out, ref) < 1e-12
    # the coarse solver on a per-element stack: K(young) again
    Ke = torch.tensor(young)[..., None, None] * pt.K0
    dcs = tsolvers.DenseCoarseSolver(pt.grid)
    chol = dcs.factor(Ke, pt.dirichlet_mask)
    assert _rel(dcs.solve(chol, pt.force, pt.dirichlet_mask), ref) < 1e-12
