"""The last two solver settings of ndr_tpu_torch vs the JAX package:
``lmax_power_iters`` (the power-iteration lambda_max estimate) and
``cached_ke_dtype="bfloat16"`` (the intermediate cached levels stored in
bf16, with the two bf16 stencil kernels' plain twins).

* Power iteration: the JAX package starts from ``jax.random.PRNGKey(7)``
  noise, the port from a ``torch.Generator`` seeded with 7, so only the
  converged estimates compare: after 200 iterations, within 1e-3
  (measured 1e-4 and below).
* bf16 stencil: the port rounds each assembled slot once where the JAX
  package rounds each element's Ke entry, so the applies are held to the
  JAX package's own bf16 tolerance, 2e-2 of max|f|
  (tests/test_pallas.py); the Ke-stack path (kernels off) casts as the
  JAX package does and agrees to fp32 rounding (1e-5).
* Solves: with either setting, the fp32 MGPCG with float64 refinement
  reaches the solution of the fp32 bound-only solve within the solver's
  tolerance (the CG operator is exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.fem import multigrid as jmg
from ndr_tpu.fem import operators as jops
from ndr_tpu.fem.simulator import problem_from_config as j_problem_from_config
from ndr_tpu.io.problem import load_problem
from ndr_tpu_torch.fem import kernels
from ndr_tpu_torch.fem import multigrid as tmg
from ndr_tpu_torch.fem import operators as tops
from ndr_tpu_torch.fem.simulator import problem_from_config as t_problem_from_config
from ndr_tpu_torch.io.problem import load_problem as t_load_problem

CANT = "problems/3d/cantilever_flexion.json"
MBB = "problems/2d/mbb_beam.json"


def _problems(path, dims, f64):
    pj, grid = j_problem_from_config(load_problem(path), dims=dims,
                                     dtype=jnp.float64 if f64 else jnp.float32)
    pt, _ = t_problem_from_config(t_load_problem(path), dims=dims,
                                  dtype=torch.float64 if f64 else torch.float32,
                                  device="cpu")
    return pj, pt, grid


@pytest.mark.parametrize("path,dims,nl", [(MBB, (24, 8), 2), (CANT, (8, 4, 4), 2)],
                         ids=["mbb24x8", "cantilever8x4x4"])
def test_power_estimate_matches_jax(path, dims, nl):
    """200 iterations converge these grids' estimates (at 16x8x8 the fine
    level's still moves by ~1e-3 between 200 and 1000 iterations, in both
    packages)."""
    pj, pt, grid = _problems(path, dims, f64=True)
    young = np.asarray(pj.young(jnp.asarray(
        np.random.default_rng(0).uniform(0.05, 1.0, grid.dims))))
    lj = jmg.build_level_states(jmg.build_mg_config(pj, nl), pj, jnp.asarray(young),
                                smoother="chebyshev", power_iters=0)
    ct = tmg.build_mg_config(pt, nl)
    lt = tmg.build_level_states(ct, pt, torch.tensor(young))
    for l in range(nl):
        est_j = float(jmg._estimate_lmax(lj[l], 200))
        est_t = float(tmg._estimate_lmax(lt[l], 200))
        assert est_t == pytest.approx(est_j, rel=1e-3), l
        # a lower estimate of the largest eigenvalue (x 1.05): below the bound
        assert est_t / 1.05 <= ct.lmax_bounds[l] * (1 + 1e-9)
    # the setting takes min(bound, (1.2 / 1.05) x estimate), read once
    lp = tmg.build_level_states(ct, pt, torch.tensor(young), power_iters=8)
    for l in range(nl + 1):
        assert isinstance(lp[l].lmax, float)
        assert lp[l].lmax <= ct.lmax_bounds[l]


def _level1(pt, grid, seed=3):
    ct = tmg.build_mg_config(pt, 1)
    rng = np.random.default_rng(seed)
    young = pt.young(torch.tensor(rng.uniform(0.1, 1.0, grid.dims), dtype=torch.float32))
    ke1 = tmg.build_level_ke(ct, young, 1)
    g1 = ct.levels[1].grid
    u = torch.tensor(rng.standard_normal(g1.nodes_per_dim + (g1.ndim,)),
                     dtype=torch.float32)
    return ke1, g1, u


@pytest.mark.parametrize("path,dims", [(MBB, (12, 6)), (CANT, (8, 4, 4)),
                                       (CANT, (6, 4, 2))])
def test_bf16_stencil_twins_match_jax(path, dims):
    """The bf16 assembly and apply (the wrappers, which take their twins on
    the CPU) against JAX's ``apply_k_cached(u, Ke1.astype(bf16))``."""
    _, pt, grid = _problems(path, dims, f64=False)
    ke1, g1, u = _level1(pt, grid)
    f_ref = np.asarray(jops.apply_k_cached(jnp.asarray(u.numpy()),
                                           jnp.asarray(ke1.numpy()).astype(jnp.bfloat16),
                                           g1), np.float64)
    S = kernels.cached_stencil_bf16(ke1.contiguous(), g1)
    assert S.dtype == torch.bfloat16 and tuple(S.shape) == kernels.stencil_shape(g1)
    torch.testing.assert_close(S, kernels.cached_stencil_plain(ke1, g1).to(torch.bfloat16),
                               rtol=0, atol=0)
    f = kernels.apply_k_cached_bf16(u, S, g1)
    assert f.dtype == torch.float32
    torch.testing.assert_close(f, kernels.apply_k_cached_bf16_plain(u, S, g1),
                               rtol=0, atol=0)
    assert np.abs(f.double().numpy() - f_ref).max() < 2e-2 * np.abs(f_ref).max()
    # the Ke-stack path casts each entry as JAX does: fp32 rounding apart
    f_stack = tops.apply_k_cached(u, ke1.to(torch.bfloat16), g1)
    assert np.abs(f_stack.double().numpy() - f_ref).max() < 1e-5 * np.abs(f_ref).max()


def _fp32_reference(pt, rho, nl):
    st = tmg.make_mg_solver(pt, tmg.MGSolverSettings(num_levels=nl, smoother="chebyshev",
                                                     cheb_degree=1))
    return st(rho)


@pytest.mark.parametrize("setting", [
    dict(cached_ke_dtype="bfloat16", use_kernels=True, smoother="chebyshev"),
    dict(cached_ke_dtype="bfloat16", use_kernels=False, smoother="chebyshev"),
    dict(cached_ke_dtype="bfloat16", use_kernels=True, smoother="gs"),
    dict(lmax_power_iters=8, smoother="chebyshev"),
], ids=["bf16-stencil-cheb", "bf16-stack-cheb", "bf16-stencil-gs", "power8"])
def test_setting_solve_reaches_fp32_solution(setting):
    """3 levels of a 16x8x8 cantilever (levels 1 and 2 held in bf16 where
    asked), fp32 with float64 refinement at tol 1e-6: the solution of the
    fp32 bound-only solve, within the tolerance."""
    _, pt, grid = _problems(CANT, (16, 8, 8), f64=False)
    rho = torch.tensor(np.random.default_rng(5).uniform(0.05, 1.0, grid.dims),
                       dtype=torch.float32)
    nl = 2
    kw = dict(num_levels=nl, cheb_degree=1, tol=1e-6)
    u_ref, it_ref = tmg.make_mg_solver(pt, tmg.MGSolverSettings(
        **kw, smoother=setting["smoother"]))(rho)
    st = tmg.make_mg_solver(pt, tmg.MGSolverSettings(**kw, **setting))
    levels = tmg.build_level_states(
        st.cfg, pt, pt.young(rho), smoother=setting["smoother"],
        use_kernels=setting.get("use_kernels", False),
        power_iters=setting.get("lmax_power_iters", 0),
        cached_ke_dtype=setting.get("cached_ke_dtype"))
    if "cached_ke_dtype" in setting:
        low = levels[1].stencil if setting["use_kernels"] else levels[1].Ke
        assert low.dtype == torch.bfloat16
        assert levels[2].Ke.dtype == torch.float32  # the coarsest stays fp32
    u, it = st(rho)
    assert it < 100 and it_ref < 100
    assert float((u - u_ref).abs().max() / u_ref.abs().max()) < 1e-5
    f = pt.force.double().reshape(-1)
    c, c_ref = float(f @ u.reshape(-1)), float(f @ u_ref.reshape(-1))
    assert c == pytest.approx(c_ref, rel=1e-6)


def test_bf16_stack_solve_matches_jax():
    """Kernels off, the Ke stacks of levels 1-2 cast to bf16 as the JAX
    package casts them: the same CG steps to the same solution (fp32
    rounding in the preconditioner apart)."""
    pj, pt, grid = _problems(CANT, (16, 8, 8), f64=False)
    rho = np.random.default_rng(6).uniform(0.05, 1.0, grid.dims).astype(np.float32)
    kw = dict(num_levels=2, smoother="chebyshev", cheb_degree=1, tol=1e-6,
              cached_ke_dtype="bfloat16")
    uj, ij = jmg.make_mg_solver(pj, jmg.MGSolverSettings(**kw))(jnp.asarray(rho))
    ut, it = tmg.make_mg_solver(pt, tmg.MGSolverSettings(**kw, use_kernels=False))(
        torch.tensor(rho))
    uj = np.asarray(uj)
    assert abs(it - int(ij)) <= 1, (it, int(ij))
    assert np.abs(ut.numpy() - uj).max() < 1e-5 * np.abs(uj).max()
