"""ndr_tpu_torch multigrid hierarchy and MGPCG vs the JAX package.

Float64 comparisons are held to rounding (1e-12 for the hierarchy, 1e-8
for a whole solve). The fp32 path with float64 refinement is held to its
compliance at 1e-5: both solves stop at the same 1e-4 residual test, and
what remains is fp32 rounding in the preconditioner.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.fem import multigrid as jmg
from ndr_tpu.fem.simulator import problem_from_config as j_problem_from_config
from ndr_tpu.io.problem import load_problem
from ndr_tpu_torch.fem import kernels
from ndr_tpu_torch.fem import multigrid as tmg
from ndr_tpu_torch.fem.simulator import problem_from_config as t_problem_from_config
from ndr_tpu_torch.grid import Grid as TGrid
from ndr_tpu_torch.io.problem import load_problem as t_load_problem

CASES = [
    ("problems/2d/mbb_beam.json", (24, 8), 1),
    ("problems/3d/cantilever_flexion.json", (16, 8, 8), 2),
]
IDS = ["mbb24x8-mgl1", "cantilever16x8x8-mgl2"]


def _problems(prob_path, dims, f64=True):
    """(JAX problem, port problem on the CPU, JAX grid) from one config."""
    pj, grid = j_problem_from_config(
        load_problem(prob_path), dims=dims,
        dtype=jnp.float64 if f64 else jnp.float32)
    pt, _ = t_problem_from_config(
        t_load_problem(prob_path), dims=dims,
        dtype=torch.float64 if f64 else torch.float32, device="cpu")
    return pj, pt, grid


def _port_grid(grid) -> TGrid:
    """The port's Grid with the fields of a JAX-side Grid."""
    return TGrid(**dataclasses.asdict(grid))


def _rel(out: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(out.double().numpy() - ref).max() / np.abs(ref).max())


def _young(pj, grid, seed=0):
    rng = np.random.default_rng(seed)
    return np.asarray(pj.young(jnp.asarray(rng.uniform(0.05, 1.0, grid.dims))))


@pytest.mark.parametrize("prob_path,dims,nl", CASES, ids=IDS)
def test_build_mg_config_matches_jax(prob_path, dims, nl):
    pj, pt, grid = _problems(prob_path, dims)
    cj, ct = jmg.build_mg_config(pj, nl), tmg.build_mg_config(pt, nl)
    assert ct.num_levels == cj.num_levels == nl + 1
    for l in range(nl + 1):
        assert ct.levels[l].grid == _port_grid(cj.levels[l].grid)
        np.testing.assert_array_equal(ct.levels[l].dirichlet_mask.numpy(),
                                      cj.levels[l].dirichlet_mask)
        assert ct.level_kind(l) == cj.level_kind(l)
    for l in range(1, nl + 1):
        np.testing.assert_allclose(ct.c_stacks[l], cj.c_stack(l), rtol=0,
                                   atol=1e-14)
    assert ct.lmax_bounds == pytest.approx(cj.lmax_bounds, rel=1e-12)
    np.testing.assert_allclose(tmg.coarsened_k0s(ct.K0, grid.ndim), cj.ck0,
                               rtol=0, atol=1e-14)
    np.testing.assert_array_equal(tmg.compressed_interpolation_phis(grid.ndim),
                                  cj.phis)


@pytest.mark.parametrize("prob_path,dims,nl", CASES, ids=IDS)
def test_level_ke_and_coarsen_ke_match_jax(prob_path, dims, nl):
    pj, pt, grid = _problems(prob_path, dims)
    cj, ct = jmg.build_mg_config(pj, nl), tmg.build_mg_config(pt, nl)
    young = _young(pj, grid)
    for l in range(1, nl + 1):
        ref = jmg.build_level_ke(cj, jnp.asarray(young), l)
        out = tmg.build_level_ke(ct, torch.tensor(young), l)
        assert _rel(out, ref) < 1e-12
    ke1 = np.asarray(jmg.build_level_ke(cj, jnp.asarray(young), 1))
    ref = jmg.coarsen_ke(jnp.asarray(ke1), grid.ndim)
    out = tmg.coarsen_ke(torch.tensor(ke1), grid.ndim)
    assert _rel(out, ref) < 1e-12


@pytest.mark.parametrize("prob_path,dims,nl", CASES, ids=IDS)
def test_transfers_match_jax(prob_path, dims, nl):
    _, _, grid = _problems(prob_path, dims)
    coarse = grid.coarsened()
    rng = np.random.default_rng(1)
    uc = rng.standard_normal(coarse.nodes_per_dim + (grid.ndim,))
    rf = rng.standard_normal(grid.nodes_per_dim + (grid.ndim,))
    ref_p = jmg.prolongate(jnp.asarray(uc), grid.ndim)
    ref_r = jmg.restrict(jnp.asarray(rf), grid.ndim)
    assert _rel(tmg.prolongate(torch.tensor(uc), grid.ndim), ref_p) < 1e-15
    assert _rel(tmg.restrict(torch.tensor(rf), grid.ndim), ref_r) < 1e-15


@pytest.mark.parametrize("prob_path,dims,nl", CASES, ids=IDS)
def test_chebyshev_smooth_matches_jax(prob_path, dims, nl):
    pj, pt, grid = _problems(prob_path, dims)
    cj, ct = jmg.build_mg_config(pj, nl), tmg.build_mg_config(pt, nl)
    young = _young(pj, grid, seed=2)
    lj = jmg.build_level_states(cj, pj, jnp.asarray(young),
                                smoother="chebyshev", power_iters=0)
    lt = tmg.build_level_states(ct, pt, torch.tensor(young))
    rng = np.random.default_rng(3)
    for l in range(nl):  # every smoothed (non-coarsest) level
        g = lt[l].grid
        assert lt[l].lmax == pytest.approx(float(lj[l].lmax), rel=1e-15)
        assert _rel(lt[l].Dinv, lj[l].Dinv) < 1e-12
        x = rng.standard_normal(g.nodes_per_dim + (g.ndim,))
        b = rng.standard_normal(g.nodes_per_dim + (g.ndim,))
        xj, rj = jmg.chebyshev_smooth(lj[l], jnp.asarray(x), jnp.asarray(b),
                                      degree=3, need_r=True)
        xt, rt = tmg.chebyshev_smooth(lt[l], torch.tensor(x), torch.tensor(b),
                                      degree=3, need_r=True)
        assert _rel(xt, xj) < 1e-12
        assert _rel(rt, rj) < 1e-12


def _settings(mod, nl, **kw):
    return mod.MGSolverSettings(num_levels=nl, smoother="chebyshev",
                                cheb_degree=1, **kw)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("prob_path,dims,nl", CASES, ids=IDS)
def test_mgpcg_solve_f64_matches_jax(prob_path, dims, nl, use_kernels):
    """Float64 end to end. With kernels on, the levels go through the
    float64 kernel wrappers (their plain twins on CPU tensors: the node
    stencil on the cached levels)."""
    pj, pt, grid = _problems(prob_path, dims)
    rho = np.random.default_rng(4).uniform(0.05, 1.0, grid.dims)
    sj = jmg.make_mg_solver(pj, _settings(jmg, nl))
    uj, itj = jax.jit(lambda r: sj(r, None))(jnp.asarray(rho))
    st = tmg.make_mg_solver(pt, _settings(tmg, nl, use_kernels=use_kernels))
    ut, itt = st(torch.tensor(rho))
    assert itt == int(itj)
    assert ut.dtype == torch.float64
    assert _rel(ut, uj) < 1e-8


@functools.lru_cache(maxsize=None)
def _jax_refined_solution(prob_path, dims, nl):
    pj, _, grid = _problems(prob_path, dims, f64=False)
    rho = np.random.default_rng(5).uniform(0.05, 1.0, grid.dims).astype(np.float32)
    sj = jmg.make_mg_solver(pj, _settings(jmg, nl))
    return np.asarray(jax.jit(lambda r: sj(r, None)[0])(jnp.asarray(rho)))


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("prob_path,dims,nl", CASES, ids=IDS)
def test_mgpcg_solve_refined_matches_jax(prob_path, dims, nl, use_kernels):
    """The default fp32 MGPCG with float64 refinement. ``use_kernels``
    routes the levels through the kernel wrappers (their twins on the
    CPU), i.e. the stream layout and the float64 residual apply."""
    pj, pt, grid = _problems(prob_path, dims, f64=False)
    rho = np.random.default_rng(5).uniform(0.05, 1.0, grid.dims).astype(np.float32)
    uj = _jax_refined_solution(prob_path, dims, nl)
    st = tmg.make_mg_solver(pt, _settings(tmg, nl, use_kernels=use_kernels))
    kernels.reset_launches()
    ut, _ = st(torch.tensor(rho))
    assert ut.dtype == torch.float64
    assert sum(kernels.launches.values()) == 0  # CPU tensors: twins only
    f = np.asarray(pj.force, np.float64).reshape(-1)
    cj = f @ np.asarray(uj).reshape(-1)
    ct = f @ ut.numpy().reshape(-1)
    assert abs(ct - cj) / abs(cj) < 1e-5
