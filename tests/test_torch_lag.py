"""The lagged multigrid preconditioner of ndr_tpu_torch vs the JAX package.

A hierarchy built at an earlier density (``solve.build_precond(rho0)``)
preconditions the solve at the current one; the CG operator, and the
refined path's float64 residual, always use the current density. Both
packages build the same state and solve the same systems: in float64 the
solutions agree to rounding (held to 1e-10 of max|u|, measured ~1e-13) with
equal CG counts, with level 0 refreshed to the current density and
without, and through transfer-kind levels. The fp32 path with float64
refinement is held to its compliance at 1e-5 and its solution at 1e-5 of
max|u| (fp32 rounding in the preconditioner, as in test_torch_multigrid).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.fem import multigrid as jmg
from ndr_tpu.fem.simulator import problem_from_config as j_problem_from_config
from ndr_tpu.io.problem import load_problem
from ndr_tpu_torch.fem import multigrid as tmg
from ndr_tpu_torch.fem.simulator import problem_from_config as t_problem_from_config
from ndr_tpu_torch.io.problem import load_problem as t_load_problem

CANT = "problems/3d/cantilever_flexion.json"
DIMS = (16, 8, 8)
RTOL_F64 = 1e-10


def _problems(f64=True):
    pj, grid = j_problem_from_config(load_problem(CANT), dims=DIMS,
                                     dtype=jnp.float64 if f64 else jnp.float32)
    pt, _ = t_problem_from_config(t_load_problem(CANT), dims=DIMS,
                                  dtype=torch.float64 if f64 else torch.float32,
                                  device="cpu")
    return pj, pt, grid


def _densities(grid, seed, drift=0.2):
    """rho0 uniform, rho1 one OC-sized move (limit 0.2) away from it."""
    rng = np.random.default_rng(seed)
    rho0 = np.full(grid.dims, 0.4)
    rho1 = np.clip(rho0 + rng.uniform(-drift, drift, grid.dims), 0.05, 1.0)
    return rho0, rho1


def _rel(u_t: torch.Tensor, u_j) -> float:
    u_j = np.asarray(u_j, np.float64)
    return float(np.abs(u_t.double().numpy() - u_j).max() / np.abs(u_j).max())


def _lagged_pair(pj, pt, kw, rho0, rho1, dtype):
    """(JAX (u, iters), port (u, iters)) of solve(rho1, precond=build(rho0))."""
    sj = jmg.make_mg_solver(pj, jmg.MGSolverSettings(**kw))
    st = tmg.make_mg_solver(pt, tmg.MGSolverSettings(**kw))
    leaves = sj.build_precond(jnp.asarray(rho0, dtype))
    uj, ij = sj(jnp.asarray(rho1, dtype), None, precond=leaves)
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    state = st.build_precond(torch.tensor(rho0, dtype=tdt))
    ut, it = st(torch.tensor(rho1, dtype=tdt), None, precond=state)
    return (uj, int(ij)), (ut, it), st


@pytest.mark.parametrize("refresh", [True, False], ids=["refresh-fine", "stale-fine"])
def test_lagged_solve_matches_jax(refresh):
    """Level 0 refreshed to the current density (the default) or left at
    the lagged one: both packages take the same CG steps to the current
    operator's solution."""
    pj, pt, grid = _problems()
    rho0, rho1 = _densities(grid, 3)
    kw = dict(num_levels=2, cg_iter=300, tol=1e-10, smoother="chebyshev",
              mixed_precision=False, precond_refresh_fine=refresh)
    (uj, ij), (ut, it), st = _lagged_pair(pj, pt, kw, rho0, rho1, jnp.float64)
    assert it == ij
    assert _rel(ut, uj) < RTOL_F64
    # the lagged state only preconditions: the fresh solve reaches the same u
    u_fresh, it_fresh = st(torch.tensor(rho1), None)
    assert _rel(ut, u_fresh.numpy()) < 1e-8
    assert it < kw["cg_iter"] and it_fresh < kw["cg_iter"]


def test_lagged_refined_matches_jax():
    """fp32 problem, float64 refinement: the lagged fp32 MGPCG inside, the
    true residual at the current density."""
    pj, pt, grid = _problems(f64=False)
    rho0, rho1 = _densities(grid, 4)
    kw = dict(num_levels=2, cg_iter=300, tol=1e-6, smoother="chebyshev",
              mixed_precision=True)
    (uj, ij), (ut, it), _ = _lagged_pair(pj, pt, kw, rho0, rho1, jnp.float32)
    assert ut.dtype == torch.float64 and uj.dtype == jnp.float64
    assert _rel(ut, uj) < 1e-5
    f = pt.force.double().reshape(-1)
    cj = float(f @ torch.tensor(np.asarray(uj)).reshape(-1))
    assert float(f @ ut.reshape(-1)) == pytest.approx(cj, rel=1e-5)
    assert abs(it - ij) <= 1, (it, ij)


def test_lagged_transfer_levels_match_jax():
    """Every intermediate level a transfer level (R K_finer P): the state
    carries no Ke there, and a refreshed level 0 reaches it through the
    parent link."""
    pj, pt, grid = _problems()
    rng = np.random.default_rng(7)
    rho = rng.uniform(0.2, 1.0, grid.dims)
    rho2 = np.clip(rho + rng.uniform(-0.05, 0.05, grid.dims), 0.05, 1.0)
    kw = dict(num_levels=2, cg_iter=100, tol=1e-8, smoother="chebyshev",
              mixed_precision=False, ke_cache_limit_bytes=0,
              coarse_solver="cholesky")
    (uj, ij), (ut, it), st = _lagged_pair(pj, pt, kw, rho, rho2, jnp.float64)
    assert [st.cfg.level_kind(l) for l in range(3)] == ["fine", "transfer", "cached"]
    assert it == ij < kw["cg_iter"]
    assert _rel(ut, uj) < RTOL_F64
    # at its own density the state reproduces the fresh solve
    state = st.build_precond(torch.tensor(rho))
    assert state.levels[1].parent is state.levels[0]
    u_same, it_same = st(torch.tensor(rho), None, precond=state)
    u_fresh, it_fresh = st(torch.tensor(rho), None)
    assert it_same == it_fresh
    torch.testing.assert_close(u_same, u_fresh, rtol=0, atol=0)


@pytest.mark.parametrize("smoother", ["chebyshev", "gs"])
def test_rebuild_into_keeps_tensors(smoother):
    """``build_precond(rho, into=state)`` writes the new hierarchy into the
    state's own tensors (what keeps a captured CUDA graph valid): the same
    objects, the values of a fresh build, and the same solve."""
    _, pt, grid = _problems()
    rho0, rho1 = _densities(grid, 5)
    kw = dict(num_levels=2, cg_iter=200, tol=1e-10, smoother=smoother,
              mixed_precision=False)
    st = tmg.make_mg_solver(pt, tmg.MGSolverSettings(**kw))
    state = st.build_precond(torch.tensor(rho0))
    held = [(lv.young, lv.Ke, lv.Minv_rows, lv.Dinv) for lv in state.levels]
    coarse = state.coarse[1]
    assert st.build_precond(torch.tensor(rho1), into=state) is state
    fresh = st.build_precond(torch.tensor(rho1))
    for lv, lf, h in zip(state.levels, fresh.levels, held):
        for f, t in zip(("young", "Ke", "Minv_rows", "Dinv"), h):
            assert getattr(lv, f) is t
            if t is not None:
                torch.testing.assert_close(t, getattr(lf, f), rtol=0, atol=0)
    assert state.coarse[1] is coarse
    torch.testing.assert_close(coarse, fresh.coarse[1], rtol=0, atol=0)
    u_into, it_into = st(torch.tensor(rho1), None, precond=state)
    u_fresh, it_fresh = st(torch.tensor(rho1), None, precond=fresh)
    assert it_into == it_fresh
    torch.testing.assert_close(u_into, u_fresh, rtol=0, atol=0)
