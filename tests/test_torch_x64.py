"""Float64 end to end with the kernels on: ndr_tpu_torch vs the JAX package.

A float64 hierarchy built with ``use_kernels=True`` applies level 0 with
the float64 fine kernel and its cached levels from float64 node stencils
(``kernels.cached_stencil_f64`` / ``apply_k_cached_f64``). On the CPU the
wrappers run their plain twins, so these tests hold that routing, and the
twins, to the JAX package in float64 (x64 enabled), where the JAX package
applies the same levels in XLA (its Pallas kernels are fp32-only). The
stencil twins agree with JAX's ``apply_k_cached`` to 1e-13 of max|f|; a
whole solve and a 3-step classic run, to 1e-11 with equal CG counts (the
stencil sums each row in another order than the element stack).
"""

import dataclasses

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
from ndr_tpu_torch.fem import kernels
from ndr_tpu_torch.fem import multigrid as tmg
from ndr_tpu_torch.fem.simulator import problem_from_config as t_problem_from_config
from ndr_tpu_torch.grid import Grid as TGrid
from ndr_tpu_torch.io.problem import load_problem as t_load_problem
from ndr_tpu_torch.training.classic import ground_truth_topopt as t_gt

CANT = "problems/3d/cantilever_flexion.json"
MBB = "problems/2d/mbb_beam.json"
_quiet = lambda s: None


def _rel(out: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(out.double().numpy() - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("prob_path,dims,level", [
    (MBB, (24, 8), 1), (CANT, (16, 8, 8), 1), (CANT, (16, 8, 8), 2)])
def test_f64_stencil_twins_match_jax_apply_k_cached(prob_path, dims, level):
    """On a Galerkin level's float64 Ke stack: the f64 assembly twin, then
    the f64 apply twin, against JAX's float64 ``apply_k_cached``; the
    wrappers take their twins for CPU tensors, bitwise, and launch
    nothing."""
    pj, jgrid = j_problem_from_config(load_problem(prob_path), dims=dims,
                                      dtype=jnp.float64)
    rng = np.random.default_rng(11)
    cfg = jmg.build_mg_config(pj, level)
    young = pj.young(jnp.asarray(rng.uniform(0.05, 1.0, jgrid.dims)))
    Ke = jmg.build_level_ke(cfg, young, 1)
    for _ in range(2, level + 1):
        Ke = jmg.coarsen_ke(Ke, jgrid.ndim)
    g = cfg.levels[level].grid
    u = rng.standard_normal(g.nodes_per_dim + (g.ndim,))
    ref = jops.apply_k_cached(jnp.asarray(u), Ke, g)
    tg = TGrid(**dataclasses.asdict(g))
    Ket, ut = torch.tensor(np.asarray(Ke)), torch.tensor(u)
    S = kernels.cached_stencil_f64_plain(Ket, tg)
    assert S.dtype == torch.float64 and S.shape == kernels.stencil_shape(tg)
    out = kernels.apply_k_cached_f64_plain(ut, S, tg)
    assert out.dtype == torch.float64
    assert _rel(out, ref) < 1e-13
    kernels.reset_launches()
    S_w = kernels.cached_stencil_f64(Ket, tg)
    torch.testing.assert_close(S_w, S, rtol=0, atol=0)
    torch.testing.assert_close(kernels.apply_k_cached(ut, S_w, tg), out, rtol=0, atol=0)
    assert kernels.launches == {name: 0 for name in kernels.launches}


def test_f64_hierarchy_routes_through_f64_wrappers():
    """With kernels on, a float64 hierarchy holds float64 stencils on its
    non-coarsest cached levels and applies level 0 with the float64 fine
    wrapper of ``fine_kernel``; the coarsest keeps its stack (Cholesky)."""
    pt, _ = t_problem_from_config(t_load_problem(CANT), dims=(16, 8, 8),
                                  dtype=torch.float64, device="cpu")
    cfg = tmg.build_mg_config(pt, 2)
    young = pt.young(torch.full((16, 8, 8), 0.5, dtype=torch.float64))
    for fk, fine in (("flat32", kernels.apply_k_fine_f64),
                     ("flat", kernels.apply_k_fine_elem_f64)):
        levels = tmg.build_level_states(cfg, pt, young, use_kernels=True, fine_kernel=fk)
        assert levels[0].fine_apply is fine
        assert levels[1].stencil.dtype == torch.float64 and levels[1].Ke is None
        assert levels[2].stencil is None and levels[2].Ke.dtype == torch.float64
    assert tmg._resolve_coarse_solver(tmg.MGSolverSettings(), levels) == "cholesky"


@pytest.mark.parametrize("prob_path,dims,nl,smoother", [
    (CANT, (16, 8, 8), 2, "chebyshev"),
    # JAX's GS solve compiles for minutes in 3-D on the CPU: GS in 2-D
    (MBB, (24, 8), 1, "gs"),
], ids=["cantilever-chebyshev", "mbb-gs"])
def test_f64_mgpcg_with_kernels_matches_jax(prob_path, dims, nl, smoother):
    pj, _ = j_problem_from_config(load_problem(prob_path), dims=dims, dtype=jnp.float64)
    pt, grid = t_problem_from_config(t_load_problem(prob_path), dims=dims,
                                     dtype=torch.float64, device="cpu")
    rho = np.random.default_rng(4).uniform(0.05, 1.0, grid.dims)
    kw = dict(num_levels=nl, smoother=smoother, cheb_degree=1)
    sj = jmg.make_mg_solver(pj, jmg.MGSolverSettings(**kw))
    uj, itj = jax.jit(lambda r: sj(r, None))(jnp.asarray(rho))
    st = tmg.make_mg_solver(pt, tmg.MGSolverSettings(**kw, use_kernels=True))
    ut, itt = st(torch.tensor(rho))
    assert itt == int(itj)
    assert ut.dtype == torch.float64
    assert _rel(ut, uj) < 1e-11


def test_f64_classic_with_kernels_matches_jax():
    """3 OC steps of the float64 classic path, cantilever 16x8x8, mgl=2."""
    kw = dict(dims=(16, 8, 8), max_iter=3, multigrid_levels=2)
    jlines, lines = [], []
    rj = j_gt(load_problem(CANT), dtype=jnp.float64, log=jlines.append, **kw)
    rt = t_gt(t_load_problem(CANT), dtype=torch.float64, device="cpu",
              use_kernels=True, log=lines.append, **kw)
    iters = [[int(s.split("cg_iters ")[1]) for s in ls if "Total Steps" in s]
             for ls in (jlines, lines)]
    np.testing.assert_allclose(rt.history, np.asarray(rj.history), rtol=1e-11, atol=0)
    assert rt.compliance == pytest.approx(rj.compliance, rel=1e-11)
    np.testing.assert_allclose(rt.densities, np.asarray(rj.densities), rtol=0, atol=1e-11)
    assert iters[1] == iters[0] and len(iters[1]) == 3
    assert any("Stiffness applies: the kernel wrappers" in s for s in lines)
