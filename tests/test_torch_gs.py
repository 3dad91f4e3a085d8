"""The multicolor Gauss-Seidel smoother of ndr_tpu_torch vs the JAX package.

Float64 on the CPU: the colour classes, the parity apply K du (fine
level, a cached level from its Ke stack and from its node stencil) and
whole forward and backward sweeps agree with ``ndr_tpu.fem.multigrid`` to
rounding (measured <= 4e-16; held to 1e-12), and a sweep agrees with the
naive sweep that recomputes r = b - K u before every colour. An fp32
sweep through the kernel wrappers (their twins on the CPU: the cached
levels hold only their stencil) is held to the plain fp32 sweep at 1e-5.
"""

import dataclasses

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
from ndr_tpu_torch.io.problem import load_problem as t_load_problem

# 2-D and 3-D; 12x6 and 6x4x2 have odd coarse dims (3x... / 3x2x1)
CASES = [
    ("problems/2d/mbb_beam.json", (24, 8), 2),
    ("problems/2d/mbb_beam.json", (12, 6), 1),
    ("problems/3d/cantilever_flexion.json", (8, 4, 4), 1),
    ("problems/3d/cantilever_flexion.json", (6, 4, 2), 1),
]
IDS = ["mbb24x8", "mbb12x6", "cantilever8x4x4", "cantilever6x4x2"]
TOL = 1e-12


def _rel(out: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(out.double().numpy() - ref).max() / np.abs(ref).max())


def _hierarchies(prob_path, dims, nl, seed=0):
    """(JAX levels, port levels) of one random density, GS hierarchies."""
    pj, grid = j_problem_from_config(load_problem(prob_path), dims=dims,
                                     dtype=jnp.float64)
    pt, _ = t_problem_from_config(t_load_problem(prob_path), dims=dims,
                                  dtype=torch.float64, device="cpu")
    rho = np.random.default_rng(seed).uniform(0.05, 1.0, grid.dims)
    young = np.asarray(pj.young(jnp.asarray(rho)))
    lj = jmg.build_level_states(jmg.build_mg_config(pj, nl), pj, jnp.asarray(young),
                                smoother="gs")
    lt = tmg.build_level_states(tmg.build_mg_config(pt, nl), pt, torch.tensor(young),
                                smoother="gs")
    return lj, lt


def _with_stencil(lv):
    """A cached level that holds only its node stencil (the layout of the
    non-coarsest cached levels with kernels on), built by the twin."""
    return dataclasses.replace(lv, stencil=kernels.cached_stencil_plain(lv.Ke, lv.grid),
                               Ke=None)


@pytest.mark.parametrize("prob_path,dims,nl", CASES, ids=IDS)
def test_colors_match_jax_masks(prob_path, dims, nl):
    pj, grid = j_problem_from_config(load_problem(prob_path), dims=dims,
                                     dtype=jnp.float64)
    pt, _ = t_problem_from_config(t_load_problem(prob_path), dims=dims,
                                  dtype=torch.float64, device="cpu")
    cj, ct = jmg.build_mg_config(pj, nl), tmg.build_mg_config(pt, nl)
    for lj, lt in zip(cj.levels, ct.levels):
        masks = np.zeros((len(lt.colors),) + lt.grid.nodes_per_dim, bool)
        for m, c in zip(masks, lt.colors):
            m[tmg.color_slices(lt.grid, c)] = True
        np.testing.assert_array_equal(masks, lj.color_masks)


@pytest.mark.parametrize("prob_path,dims,nl", CASES, ids=IDS)
def test_apply_k_parity_matches_jax(prob_path, dims, nl):
    """Every level and colour; cached levels from the Ke stack and from
    the node stencil."""
    lj, lt = _hierarchies(prob_path, dims, nl)
    rng = np.random.default_rng(1)
    for l in range(nl + 1):
        g = lt[l].grid
        forms = [lt[l]] + ([_with_stencil(lt[l])] if lt[l].kind == "cached" else [])
        for p in lt[l].colors:
            sl = tmg.color_slices(g, p)
            du = np.zeros(g.nodes_per_dim + (g.ndim,))
            du[sl] = rng.standard_normal(du[sl].shape)
            ref = jmg.apply_k_parity(lj[l], jnp.asarray(du), p)
            for lv in forms:
                out = tmg.apply_k_parity(lv, torch.tensor(du[sl]), p)
                assert _rel(out, ref) < TOL, (l, lv.kind, lv.stencil is not None, p)


@pytest.mark.parametrize("prob_path,dims,nl", CASES, ids=IDS)
def test_gs_sweep_matches_jax_and_naive(prob_path, dims, nl):
    lj, lt = _hierarchies(prob_path, dims, nl, seed=2)
    rng = np.random.default_rng(3)
    for l in range(nl + 1):
        g = lt[l].grid
        b = rng.standard_normal(g.nodes_per_dim + (g.ndim,))
        u = rng.standard_normal(b.shape)
        forms = [lt[l]] + ([_with_stencil(lt[l])] if lt[l].kind == "cached" else [])
        for forward in (True, False):
            ref = jmg.gs_sweep(lj[l], jnp.asarray(u), jnp.asarray(b), forward=forward)
            # the naive sweep: the full residual before every colour
            naive = torch.tensor(u)
            for c in (lt[l].colors if forward else lt[l].colors[::-1]):
                r = torch.tensor(b) - tmg._apply_k_level(lt[l], naive)
                naive = naive.clone()
                naive[tmg.color_slices(g, c)] += tmg._gs_trisolve_color(lt[l], r, c,
                                                                         forward)
            for lv in forms:
                out = tmg.gs_sweep(lv, torch.tensor(u), torch.tensor(b), forward=forward)
                assert _rel(out, ref) < TOL, (l, forward, lv.stencil is not None)
                assert _rel(out, naive.numpy()) < TOL, (l, forward)


@pytest.mark.parametrize("prob_path,dims,nl", [
    ("problems/2d/mbb_beam.json", (24, 8), 2),
    ("problems/3d/cantilever_flexion.json", (8, 4, 4), 2),
], ids=["mbb24x8", "cantilever8x4x4"])
def test_gs_sweep_f32_with_kernels_matches_plain(prob_path, dims, nl):
    """fp32 hierarchy with kernels on (CPU: the wrappers' twins, the
    non-coarsest cached levels as stencils) against the plain hierarchy."""
    pt, grid = t_problem_from_config(t_load_problem(prob_path), dims=dims,
                                     dtype=torch.float32, device="cpu")
    cfg = tmg.build_mg_config(pt, nl)
    young = pt.young(torch.tensor(np.random.default_rng(4).uniform(0.05, 1.0, grid.dims),
                                  dtype=torch.float32))
    plain = tmg.build_level_states(cfg, pt, young, smoother="gs")
    kern = tmg.build_level_states(cfg, pt, young, smoother="gs", use_kernels=True)
    assert kern[1].stencil is not None and kern[1].Ke is None
    assert plain[0].Dinv is None and plain[0].lmax is None  # Chebyshev only
    rng = np.random.default_rng(5)
    for l in range(nl + 1):
        g = plain[l].grid
        b = torch.tensor(rng.standard_normal(g.nodes_per_dim + (g.ndim,)), dtype=torch.float32)
        u = torch.tensor(rng.standard_normal(b.shape), dtype=torch.float32)
        for forward in (True, False):
            ref = tmg.gs_sweep(plain[l], u, b, forward)
            assert _rel(tmg.gs_sweep(kern[l], u, b, forward), ref.numpy()) < 1e-5
