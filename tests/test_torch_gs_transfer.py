"""Transfer-kind multigrid levels and the classic SIMP-OC trajectory with
the Gauss-Seidel smoother, ndr_tpu_torch vs the JAX package (float64,
CPU). The JAX GS solves compile for ~10-20 s each in 2-D (~60-115 s in
3-D), so the solves held to JAX run on the 2-D MBB beam.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.fem import multigrid as jmg
from ndr_tpu.fem import operators as jops
from ndr_tpu.fem.simulator import problem_from_config as j_problem_from_config
from ndr_tpu.io.problem import load_problem
from ndr_tpu.training.classic import ground_truth_topopt as j_gt
from ndr_tpu_torch.fem import multigrid as tmg
from ndr_tpu_torch.fem import operators as tops
from ndr_tpu_torch.fem import solvers as tsolvers
from ndr_tpu_torch.fem.simulator import problem_from_config as t_problem_from_config
from ndr_tpu_torch.io.problem import load_problem as t_load_problem
from ndr_tpu_torch.training.classic import ground_truth_topopt as t_gt

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


@pytest.mark.parametrize("prob_path,dims", [(MBB, (16, 8)), (CANT, (8, 4, 4))],
                         ids=["mbb16x8", "cantilever8x4x4"])
def test_transfer_level_matches_jax(prob_path, dims):
    """Level 1 forced to the transfer kind (R K_fine P): its smoother
    diagonals from the per-element diagonal blocks, its apply and its GS
    sweep (full apply per colour) against JAX; a GS solve through it
    against the dense oracle, and in 2-D against JAX."""
    pj, pt, grid = _problems(prob_path, dims)
    cj = jmg.build_mg_config(pj, 2, ke_cache_limit_bytes=1)
    ct = tmg.build_mg_config(pt, 2, ke_cache_limit_bytes=1)
    assert [ct.level_kind(l) for l in range(3)] == ["fine", "transfer", "cached"]
    rng = np.random.default_rng(7)
    rho = rng.uniform(0.1, 1.0, grid.dims)
    young = np.asarray(pj.young(jnp.asarray(rho)))
    for l in (1, 2):
        assert _rel(tmg.build_level_ke_diag(ct, torch.tensor(young), l),
                    jmg.build_level_ke_diag(cj, jnp.asarray(young), l)) < 1e-12
    lj = jmg.build_level_states(cj, pj, jnp.asarray(young))
    lt = tmg.build_level_states(ct, pt, torch.tensor(young), smoother="gs")
    assert lt[1].kind == "transfer" and lt[1].parent is lt[0]
    assert _rel(lt[1].Minv_rows, lj[1].Minv_rows) < 1e-12
    np.testing.assert_allclose(
        tops.node_diag_blocks_from_elem_diag(
            tmg.build_level_ke_diag(ct, torch.tensor(young), 1), lt[1].grid).numpy(),
        np.asarray(jops.node_diag_blocks_from_elem_diag(
            jmg.build_level_ke_diag(cj, jnp.asarray(young), 1), grid.coarsened())),
        rtol=1e-12, atol=0)
    g = lt[1].grid
    u = rng.standard_normal(g.nodes_per_dim + (g.ndim,))
    b = rng.standard_normal(u.shape)
    assert _rel(tmg._apply_k_level(lt[1], torch.tensor(u)),
                jmg._apply_k_level(lj[1], jnp.asarray(u))) < 1e-12
    for forward in (True, False):
        assert _rel(tmg.gs_sweep(lt[1], torch.tensor(u), torch.tensor(b), forward),
                    jmg.gs_sweep(lj[1], jnp.asarray(u), jnp.asarray(b), forward)) < 1e-12
    kw = dict(num_levels=2, tol=1e-10, ke_cache_limit_bytes=1)
    ut, itt = tmg.make_mg_solver(pt, tmg.MGSolverSettings(**kw))(torch.tensor(rho))
    assert _rel(ut, _dense(pt, rho)) < 1e-8
    if grid.ndim == 2:
        sj = jmg.make_mg_solver(pj, jmg.MGSolverSettings(**kw))
        uj, itj = jax.jit(lambda r: sj(r, None))(jnp.asarray(rho))
        assert itt == int(itj)
        assert _rel(ut, uj) < TOL


def test_classic_gs_history_matches_jax():
    """``ground_truth_topopt(..., smoother="gs")``, 3 OC steps in float64
    (measured 2.4e-13)."""
    quiet = lambda s: None
    rj = j_gt(load_problem(MBB), dims=(24, 8), max_iter=3, multigrid_levels=1,
              smoother="gs", dtype=jnp.float64, log=quiet)
    rt = t_gt(t_load_problem(MBB), dims=(24, 8), max_iter=3, multigrid_levels=1,
              smoother="gs", dtype=torch.float64, device="cpu", log=quiet)
    np.testing.assert_allclose(rt.history, rj.history, rtol=TOL, atol=0)
    np.testing.assert_allclose(rt.densities, np.asarray(rj.densities), rtol=0, atol=1e-9)
