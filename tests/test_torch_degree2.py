"""Degree-2 (quadratic Lagrange) grids in ndr_tpu_torch: the cases of
tests/test_degree2.py on the port, and the degree-2 OC run against the
JAX package.

The port's core is degree-generic on its plain paths, as the JAX
package's is on its XLA paths: element Ke, the matrix-free apply, dense
assembly, block-Jacobi CG and the dense oracle. Multigrid coarsening and
the CUDA kernels are degree-1 constructions: ``make_mg_solver`` falls back
to block-Jacobi PCG, ``use_kernels="auto"`` resolves to the plain applies
(the JAX package takes XLA there), and an explicit ``use_kernels=True``
raises.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.fem import element as jel
from ndr_tpu.io.problem import load_problem as j_load_problem
from ndr_tpu.training.classic import ground_truth_topopt as j_gt
from ndr_tpu_torch.fem import element as el
from ndr_tpu_torch.fem import multigrid as mg
from ndr_tpu_torch.fem import operators as ops
from ndr_tpu_torch.fem import solvers
from ndr_tpu_torch.fem import topopt
from ndr_tpu_torch.fem.simulator import problem_from_config
from ndr_tpu_torch.grid import make_grid
from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.training.classic import ground_truth_topopt

MBB = "problems/2d/mbb_beam.json"
_quiet = lambda s: None


def _setup(dims, corners, degree, seed=0):
    grid = make_grid(dims, corners, degree=degree)
    mat = el.IsotropicMaterial(1.0, 0.3, grid.ndim)
    K0 = el.element_stiffness_matrix(tuple([degree] * grid.ndim), grid.stretchings, mat)
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.05, 1.0, size=grid.dims)
    young = 1e-4 + rho ** 3 * (1 - 1e-4)
    return grid, np.asarray(K0), young, rng


def _mbb_problem(dims, degree):
    cfg = dataclasses.replace(load_problem(MBB), order_fem=(degree,) * 2)
    return problem_from_config(cfg, dims=dims, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("ndim", [2, 3])
def test_degree2_ke_rigid_modes_and_symmetry(ndim):
    """Degree-2 Ke: symmetric PSD with exactly the rigid-body null space,
    and equal to the JAX package's."""
    grid, K0, _, _ = _setup((1,) * ndim, [[0] * ndim, [1.0] * ndim], degree=2)
    jK0 = np.asarray(jel.element_stiffness_matrix(
        (2,) * ndim, grid.stretchings, jel.IsotropicMaterial(1.0, 0.3, ndim)))
    np.testing.assert_allclose(K0, jK0, rtol=0, atol=1e-14 * np.abs(jK0).max())
    np.testing.assert_allclose(K0, K0.T, atol=1e-12)
    w = np.linalg.eigvalsh(K0)
    n_rigid = 3 if ndim == 2 else 6
    assert np.all(w[:n_rigid] < 1e-10 * w[-1])
    assert w[n_rigid] > 1e-6 * w[-1]
    for d in range(ndim):
        t = np.zeros((grid.nodes_per_elem, ndim))
        t[:, d] = 1.0
        np.testing.assert_allclose(K0 @ t.reshape(-1), 0.0, atol=1e-12)


@pytest.mark.parametrize("dims,corners", [
    ((3, 2), [[0, 0], [1.5, 1]]),
    ((2, 2, 2), [[0, 0, 0], [1, 1, 1]]),
])
def test_degree2_apply_k_matches_dense(dims, corners):
    grid, K0, young, rng = _setup(dims, corners, degree=2)
    K = ops.assemble_dense_k(young, K0, grid)
    np.testing.assert_allclose(K, K.T, atol=1e-12)
    u = rng.normal(size=grid.nodes_per_dim + (grid.ndim,))
    f = ops.apply_k(torch.tensor(u), torch.tensor(young), torch.tensor(K0), grid)
    np.testing.assert_allclose(f.numpy().reshape(-1), K @ u.reshape(-1),
                               rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("solver", ["cg", "make_mg_solver"])
def test_degree2_solve_matches_dense(solver):
    """The BC-pinned MBB solve on a degree-2 grid by block-Jacobi CG, and by
    ``make_mg_solver``, which clamps to num_levels=0 block-Jacobi PCG (the
    fallback of grids that cannot coarsen), against the dense oracle."""
    prob, grid = _mbb_problem((6, 2), degree=2)
    rho = torch.full(grid.dims, 0.5, dtype=torch.float64)
    young = prob.young(rho)
    u_dense = solvers.dense_solve(young, prob.K0, prob.dirichlet_mask, prob.force, grid)
    if solver == "cg":
        u, _ = topopt.solve_displacement_cg(prob, rho, tol=1e-12)
    else:
        assert mg.max_feasible_coarsenings(grid) == 0
        solve = mg.make_mg_solver(prob, mg.MGSolverSettings(num_levels=3, cg_iter=4000,
                                                            tol=1e-12))
        assert solve.settings.precond == "jacobi"
        u, _ = solve(rho)
    np.testing.assert_allclose(u.numpy(), u_dense.numpy(), rtol=1e-6, atol=1e-9)
    c = float(torch.dot(prob.force.reshape(-1), u_dense.reshape(-1)))
    assert np.isfinite(c) and c > 0


def test_degree2_kernels_resolve_to_plain_applies():
    """``use_kernels="auto"`` takes the plain applies on a degree-2 grid
    on any device; an explicit ``use_kernels=True`` raises."""
    prob, grid = _mbb_problem((6, 2), degree=2)
    assert not mg.resolve_use_kernels("auto", torch.device("cuda"), grid)
    settings = mg.MGSolverSettings(num_levels=1, cg_iter=4000, tol=1e-10)
    solve = mg.make_mg_solver(prob, settings)
    assert "degree-2 grid" in mg.describe_applies(prob, dataclasses.replace(
        solve.settings, use_kernels="auto"))
    rho = torch.full(grid.dims, 0.5, dtype=torch.float64)
    u, _ = solve(rho)
    assert bool(torch.isfinite(u).all())
    with pytest.raises(ValueError, match="degree-1"):
        mg.make_mg_solver(prob, dataclasses.replace(settings, use_kernels=True))(rho)


def test_degree2_color_classes_partition_grid():
    """(degree+1)^N colour classes partition the node lattice, and two
    nodes of one class never share an element."""
    grid = make_grid((3, 2), [[0, 0], [1.5, 1]], degree=2)
    colors = mg.parity_colors(grid)
    assert len(colors) == 9
    count = np.zeros(grid.nodes_per_dim, int)
    for c in colors:
        count[mg.color_slices(grid, c)] += 1
    np.testing.assert_array_equal(count, 1)
    offs = ops.local_node_offsets(grid)
    for c in colors:
        m = np.zeros(grid.nodes_per_dim, bool)
        m[mg.color_slices(grid, c)] = True
        for e in np.ndindex(*grid.dims):
            nodes = [tuple(2 * np.asarray(e) + o) for o in offs]
            assert sum(m[n] for n in nodes) <= 1


def test_degree2_more_accurate_than_degree1_per_element():
    """At matched element counts the quadratic compliance lies between the
    coarse degree-1 value and a fine degree-1 reference."""
    def compliance(dims, degree):
        prob, grid = _mbb_problem(dims, degree)
        rho = torch.ones(grid.dims, dtype=torch.float64)
        u = solvers.dense_solve(prob.young(rho), prob.K0, prob.dirichlet_mask,
                                prob.force, grid)
        return float(torch.dot(prob.force.reshape(-1), u.reshape(-1)))

    c1, c2, c_ref = compliance((12, 4), 1), compliance((12, 4), 2), compliance((36, 12), 1)
    assert c2 > c1
    assert abs(c2 - c_ref) < abs(c1 - c_ref)


@pytest.mark.parametrize("mgl", [0, 2], ids=["mgl0-cg", "mgl2-jacobi"])
def test_degree2_oc_matches_jax(mgl):
    """Classic OC at degree 2 through ``ground_truth_topopt``, mgl=0
    (block-Jacobi CG) and mgl=2 (clamped to block-Jacobi PCG), against the
    JAX package in float64 within 1e-10; the volume is held and compliance
    falls. The solves run to 1e-10: stopped at the default 1e-4, the two
    packages' block-Jacobi CG iterates (summed in other orders) part at
    ~7e-8, which says nothing of the degree-2 path."""
    kw = dict(dims=(12, 4), max_iter=6, multigrid_levels=mgl, tol=1e-10, log=_quiet)
    jcfg = dataclasses.replace(j_load_problem(MBB), order_fem=(2, 2))
    tcfg = dataclasses.replace(load_problem(MBB), order_fem=(2, 2))
    rj = j_gt(jcfg, dtype=jnp.float64, **kw)
    lines = []
    rt = ground_truth_topopt(tcfg, dtype=torch.float64, device="cpu",
                             **{**kw, "log": lines.append})
    assert any("Stiffness applies: plain torch ops" in s for s in lines)
    hist = np.asarray(rt.history)
    np.testing.assert_allclose(hist, np.asarray(rj.history), rtol=1e-10, atol=0)
    np.testing.assert_allclose(rt.physical, np.asarray(rj.physical), rtol=0, atol=1e-10)
    assert np.all(np.isfinite(hist)) and hist[-1] < hist[0]
    assert abs(float(np.mean(rt.physical)) - tcfg.max_volume) < 1e-3
