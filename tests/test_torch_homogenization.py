"""Periodic homogenization of ndr_tpu_torch vs ``ndr_tpu.fem.homogenization``.

Same numpy-seeded inputs through both packages in float64 on the CPU
(the port's kernel wrappers take their plain twins there). Tolerances:
the periodic maps and loads 1e-15 (the same adds); the batched CG equal
per-column counts and x within 1e-12 relative of ``jax.vmap`` of the JAX
CG; the cell problems solved to tol 1e-12, w within 1e-10 of max|w| and
Eh / dEh within 1e-11 relative (measured: 3e-13, 1e-16, 1e-13). Then the
port alone against the closed forms of JAX's own homogenization tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.fem import element as jel
from ndr_tpu.fem import homogenization as jhom
from ndr_tpu.fem import solvers as jsolvers
from ndr_tpu.grid import make_grid as j_make_grid
from ndr_tpu_torch.fem import element as tel
from ndr_tpu_torch.fem import homogenization as thom
from ndr_tpu_torch.fem import solvers as tsolvers
from ndr_tpu_torch.grid import Grid as TGrid
from ndr_tpu_torch.grid import make_grid

T = torch.tensor


def _setup(dims, E=1.0, nu=0.3):
    """(JAX grid, port grid, JAX material, port material, K0 numpy)."""
    jg = j_make_grid(dims, [[0] * len(dims), [1] * len(dims)])
    tg = TGrid(**dataclasses.asdict(jg))
    jm = jel.IsotropicMaterial(E, nu, jg.ndim)
    tm = tel.IsotropicMaterial(E, nu, jg.ndim)
    K0 = jel.element_stiffness_matrix(tuple([1] * jg.ndim), jg.stretchings, jm)
    return jg, tg, jm, tm, np.asarray(K0)


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("dims", [(4, 4), (4, 2, 2)])
def test_periodic_maps_and_loads_match_jax(dims):
    jg, tg, jm, tm, _ = _setup(dims)
    rng = np.random.default_rng(0)
    N = jg.ndim
    u = rng.standard_normal(jg.dims + (N,))
    f = rng.standard_normal(jg.nodes_per_dim + (N,))
    rho = rng.uniform(0.3, 1.0, jg.dims)
    np.testing.assert_allclose(thom.periodic_expand(T(u), N).numpy(),
                               np.asarray(jhom.periodic_expand(jnp.asarray(u), N)),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(thom.periodic_fold(T(f), N).numpy(),
                               np.asarray(jhom.periodic_fold(jnp.asarray(f), N)),
                               rtol=0, atol=1e-15)
    np.testing.assert_array_equal(thom._pin(T(u)).numpy(),
                                  np.asarray(jhom._pin(jnp.asarray(u))))
    loads_t = thom.constant_strain_loads(T(rho), tg, tm).numpy()
    loads_j = np.asarray(jhom.constant_strain_loads(jnp.asarray(rho), jg, jm))
    assert loads_t.shape == loads_j.shape == (thom.num_strains(N),) + jg.dims + (N,)
    np.testing.assert_allclose(loads_t, loads_j, rtol=0, atol=1e-15)
    # a batch of fields through the same calls, field by field
    batch = np.stack([u, 2.0 * u])
    expanded = thom.periodic_expand(T(batch), N).numpy()
    np.testing.assert_array_equal(expanded[1], thom.periodic_expand(T(2.0 * u), N).numpy())
    np.testing.assert_array_equal(thom._pin(T(batch), N).numpy()[0], thom._pin(T(u)).numpy())


def test_batched_cg_matches_vmapped_jax_cg():
    """S=4 SPD systems with 4, 7, - and 11 distinct eigenvalues, so that CG
    stops after that many iterations with a residual far below the test
    (no count sits on a rounding tie); column 2 has b = 0 (frozen from the
    start: 0 iterations, x stays 0). Scaled-identity preconditioner."""
    rng = np.random.default_rng(1)
    S, n = 4, 30
    A = np.zeros((S, n, n))
    for s, k in enumerate((4, 7, 3, 11)):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        eigs = rng.uniform(1.0, 50.0, k)[np.arange(n) % k]
        A[s] = (Q * eigs) @ Q.T
    b = rng.standard_normal((S, n))
    b[2] = 0.0

    def j_solve(Ai, bi):
        return jsolvers.conjugate_gradient(
            lambda x: Ai @ x, bi, jnp.zeros_like(bi), tol=1e-10, max_iter=500,
            precond=lambda r: r / 3.0)

    xj, itj = jax.vmap(j_solve)(jnp.asarray(A), jnp.asarray(b))
    At = T(A)

    def solve(max_iter):
        return tsolvers.conjugate_gradient_batched(
            lambda x: torch.einsum("sij,sj->si", At, x), T(b),
            torch.zeros(S, n, dtype=torch.float64), tol=1e-10, max_iter=max_iter,
            precond=lambda r: r / 3.0)

    xt, itt = solve(500)
    assert itt.shape == (S,)
    assert itt.tolist() == np.asarray(itj).tolist() == [4, 7, 0, 11]
    assert float(xt[2].abs().max()) == 0.0
    for s in (0, 1, 3):
        assert _rel(xt[s].numpy(), np.asarray(xj[s])) < 1e-12
        assert _rel(torch.einsum("ij,j->i", At[s], xt[s]).numpy(), b[s]) < 1e-10
    # max_iter caps each column
    assert solve(5)[1].tolist() == [4, 5, 0, 5]


@pytest.mark.parametrize("dims", [(4, 4), (8, 8), (4, 4, 4)])
def test_cell_problems_and_tensor_match_jax(dims):
    jg, tg, jm, tm, K0 = _setup(dims)
    rho = np.random.default_rng(0).uniform(0.3, 1.0, jg.dims)
    wj = jhom.solve_cell_problems(jnp.asarray(rho), jg, jm, jnp.asarray(K0), tol=1e-12)
    Ehj = jhom.homogenized_elasticity_tensor(wj, jnp.asarray(rho), jg, jm, jnp.asarray(K0))
    dEj = jhom.homogenized_tensor_gradient(wj, jg, jm, jnp.asarray(K0))
    wt = thom.solve_cell_problems(T(rho), tg, tm, T(K0), tol=1e-12)
    assert _rel(wt.numpy(), wj) < 1e-10
    Eht = thom.homogenized_elasticity_tensor(wt, T(rho), tg, tm, T(K0))
    dEt = thom.homogenized_tensor_gradient(wt, tg, tm, T(K0))
    assert _rel(Eht.numpy(), Ehj) < 1e-11
    assert _rel(dEt.numpy(), dEj) < 1e-11
    # homogenize: the same tensor and gradient from one energy form
    Eh2, dE2, iters = thom.homogenize(T(rho), tg, tm, T(K0), tol=1e-12)
    assert iters.shape == (thom.num_strains(jg.ndim),) and int(iters.min()) > 0
    assert _rel(Eh2.numpy(), Ehj) < 1e-11 and _rel(dE2.numpy(), dEj) < 1e-11


def _port_setup(dims, E=1.0, nu=0.3):
    grid = make_grid(dims, [[0] * len(dims), [1] * len(dims)])
    mat = tel.IsotropicMaterial(E, nu, grid.ndim)
    K0 = T(tel.element_stiffness_matrix(tuple([1] * grid.ndim), grid.stretchings, mat))
    return grid, mat, K0


@pytest.mark.parametrize("dims", [(4, 4), (4, 2, 2)])
def test_uniform_cell_recovers_base_material(dims):
    grid, mat, K0 = _port_setup(dims)
    rho = torch.ones(grid.dims, dtype=torch.float64)
    w = thom.solve_cell_problems(rho, grid, mat, K0, tol=1e-12)
    assert float(w.abs().max()) < 1e-8
    Eh = thom.homogenized_elasticity_tensor(w, rho, grid, mat).numpy()
    lam, mu = mat.lame
    np.testing.assert_allclose(Eh, thom.isotropic_voigt(lam, mu, grid.ndim), atol=1e-8)


def laminate_closed_form(lam, mu, phases):
    """Backus laminate (layers normal to x): C11, C12, C22 (2-D in-plane),
    the normal shears <1/mu>^-1 and the in-plane shear <mu>, from
    ``phases`` = [(volume fraction, density scale)]."""
    def avg(f):
        return sum(frac * f(s * lam, s * mu) for frac, s in phases)

    inv_M = avg(lambda l, m: 1.0 / (l + 2 * m))
    lam_over_M = avg(lambda l, m: l / (l + 2 * m))
    C11 = 1.0 / inv_M
    C12 = lam_over_M / inv_M
    C22 = avg(lambda l, m: (l + 2 * m) - l * l / (l + 2 * m)) + lam_over_M ** 2 / inv_M
    return C11, C12, C22, 1.0 / avg(lambda l, m: 1.0 / m), avg(lambda l, m: m)


def test_laminate_matches_closed_form():
    grid, mat, K0 = _port_setup((8, 8))
    rho = torch.ones(grid.dims, dtype=torch.float64)
    rho[: grid.dims[0] // 2] = 0.25
    w = thom.solve_cell_problems(rho, grid, mat, K0, tol=1e-12)
    Eh = thom.homogenized_elasticity_tensor(w, rho, grid, mat).numpy()
    C11, C12, C22, G, _ = laminate_closed_form(*mat.lame, [(0.5, 0.25), (0.5, 1.0)])
    np.testing.assert_allclose(Eh[0, 0], C11, rtol=1e-6)
    np.testing.assert_allclose(Eh[0, 1], C12, rtol=1e-6)
    np.testing.assert_allclose(Eh[1, 1], C22, rtol=1e-6)
    np.testing.assert_allclose(Eh[2, 2], G, rtol=1e-6)
    np.testing.assert_allclose(Eh, Eh.T, atol=1e-9)


def test_laminate_3d_matches_closed_form():
    """The 3-D laminate of the smoke's homogenization phase, at 4x4x4:
    C11, C12 = C13, the xy / xz shears <1/mu>^-1, the yz shear <mu>."""
    grid, mat, K0 = _port_setup((4, 4, 4))
    rho = torch.ones(grid.dims, dtype=torch.float64)
    rho[:2] = 0.25
    w = thom.solve_cell_problems(rho, grid, mat, K0, tol=1e-10)
    Eh = thom.homogenized_elasticity_tensor(w, rho, grid, mat).numpy()
    C11, C12, _, G, G_in = laminate_closed_form(*mat.lame, [(0.5, 0.25), (0.5, 1.0)])
    np.testing.assert_allclose([Eh[0, 0], Eh[0, 1], Eh[0, 2], Eh[4, 4], Eh[5, 5],
                                Eh[3, 3]], [C11, C12, C12, G, G, G_in], rtol=1e-6)
    np.testing.assert_allclose(Eh, Eh.T, atol=1e-9)


def test_homogenized_gradient_vs_fd():
    grid, mat, K0 = _port_setup((4, 4))
    rng = np.random.default_rng(0)
    rho0 = T(rng.uniform(0.3, 1.0, size=grid.dims))

    def Eh_of(rho):
        w = thom.solve_cell_problems(rho, grid, mat, K0, tol=1e-13)
        return thom.homogenized_elasticity_tensor(w, rho, grid, mat).numpy()

    w0 = thom.solve_cell_problems(rho0, grid, mat, K0, tol=1e-13)
    grad = thom.homogenized_tensor_gradient(w0, grid, mat, K0).numpy()
    d = rng.standard_normal(grid.dims)
    d /= np.linalg.norm(d)
    h = 1e-6
    fd = (Eh_of(rho0 + h * T(d)) - Eh_of(rho0 - h * T(d))) / (2 * h)
    an = np.einsum("xyst,xy->st", grad, d)
    np.testing.assert_allclose(an, fd, atol=2e-5 * max(1.0, np.abs(fd).max()))


def test_closest_isotropic_roundtrip():
    for ndim in (2, 3):
        mat = tel.IsotropicMaterial(2.0, 0.25, ndim)
        lam, mu = mat.lame
        C = mat.full_tensor()
        np.testing.assert_allclose(thom.closest_isotropic_lame(C), [lam, mu], rtol=1e-12)
        C2 = thom.voigt_to_full(thom.isotropic_voigt(lam, mu, ndim), ndim)
        np.testing.assert_allclose(C2, C, atol=1e-12)
        Cp = C.copy()
        Cp[0, 0, 0, 0] *= 1.3
        lam3, mu3 = thom.closest_isotropic_lame(Cp)
        eye = np.eye(ndim)
        I4 = 0.5 * (np.einsum("ik,jl->ijkl", eye, eye) + np.einsum("il,jk->ijkl", eye, eye))
        C3 = lam3 * np.einsum("ij,kl->ijkl", eye, eye) + 2 * mu3 * I4
        assert np.linalg.norm(C3 - Cp) <= np.linalg.norm(C - Cp) + 1e-12
        # the port's NumPy copies equal the JAX package's
        np.testing.assert_array_equal(thom.voigt_to_full(thom.isotropic_voigt(lam, mu, ndim),
                                                         ndim),
                                      jhom.voigt_to_full(jhom.isotropic_voigt(lam, mu, ndim),
                                                         ndim))
    g2 = make_grid((4, 4), [[0, 0], [1, 1]])
    jg2 = j_make_grid((4, 4), [[0, 0], [1, 1]])
    np.testing.assert_array_equal(thom.average_strain_matrix(g2, 2),
                                  jhom.average_strain_matrix(jg2, 2))


def test_use_kernels_on_degree2_raises():
    grid = make_grid((2, 2), [[0, 0], [1, 1]], degree=2)
    mat = tel.IsotropicMaterial(1.0, 0.3, 2)
    K0 = T(tel.element_stiffness_matrix((2, 2), grid.stretchings, mat))
    rho = torch.ones(grid.dims, dtype=torch.float64)
    with pytest.raises(ValueError, match="degree-2"):
        thom.solve_cell_problems(rho, grid, mat, K0, use_kernels=True)
    # "auto" takes the plain apply there: a uniform cell is the base material
    w = thom.solve_cell_problems(rho, grid, mat, K0, tol=1e-12)
    Eh = thom.homogenized_elasticity_tensor(w, rho, grid, mat, K0).numpy()
    np.testing.assert_allclose(Eh, thom.isotropic_voigt(*mat.lame, 2), atol=1e-8)
