"""Plain twins of the CUDA stiffness kernels vs the JAX Pallas kernels.

Each twin in ``ndr_tpu_torch.fem.kernels`` is the function its CUDA
kernel is held to on the card; here it is held to the Pallas kernel it
replaces, run in interpreter mode as ``tests/test_pallas.py`` runs it.
The kernels themselves need the card (``tests/test_torch_cuda.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.fem import multigrid as jmg
from ndr_tpu.fem import operators as jops
from ndr_tpu.fem import pallas_kernels as pk
from ndr_tpu.fem.simulator import problem_from_config as j_problem_from_config
from ndr_tpu.io.problem import load_problem
from ndr_tpu_torch.fem import kernels
from ndr_tpu_torch.fem import operators as tops
from ndr_tpu_torch.grid import Grid as TGrid

CASES = [
    ("problems/2d/mbb_beam.json", (12, 6)),
    ("problems/3d/cantilever_flexion.json", (8, 4, 4)),
    ("problems/3d/cantilever_flexion.json", (6, 4, 2)),
]
# the interpreted cached and two-float Pallas kernels are slow on the CPU;
# one 2-D and one 3-D shape (6x4x2: odd element count along y) suffice
SLOW_CASES = [CASES[0], CASES[2]]


def _port_grid(grid) -> TGrid:
    """The port's Grid with the fields of a JAX-side Grid."""
    return TGrid(**dataclasses.asdict(grid))


def _setup(prob_path, dims, dtype, seed):
    prob, grid = j_problem_from_config(load_problem(prob_path), dims=dims,
                                       dtype=dtype)
    return prob, grid, np.random.default_rng(seed)


def _rel(out: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(out.double().numpy() - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("prob_path,dims", CASES)
def test_fine_f32_twin_matches_pallas_flat(prob_path, dims):
    prob, grid, rng = _setup(prob_path, dims, jnp.float32, 0)
    young = np.asarray(prob.young(
        jnp.asarray(rng.uniform(0.1, 1.0, grid.dims), jnp.float32)))
    u = rng.standard_normal(grid.nodes_per_dim + (grid.ndim,)).astype(np.float32)
    K0_32 = np.asarray(prob.K0, np.float32)
    ref = pk.apply_k_pallas_flat(jnp.asarray(u), jnp.asarray(young),
                                 np.asarray(prob.K0), grid, interpret=True)
    out = kernels.apply_k_fine_plain(torch.tensor(u), torch.tensor(young),
                                     torch.tensor(K0_32), _port_grid(grid))
    assert out.dtype == torch.float32
    assert _rel(out, ref) < 1e-5


@pytest.mark.parametrize("prob_path,dims", SLOW_CASES)
def test_cached_f32_twin_matches_pallas_cached(prob_path, dims):
    """On a real Galerkin level-1 Ke stack: the port's node stencil
    (assembly twin, then apply twin) against the Pallas kernel on its
    stream layout."""
    prob, grid, rng = _setup(prob_path, dims, jnp.float32, 3)
    mgcfg = jmg.build_mg_config(prob, 1)
    young = prob.young(jnp.asarray(rng.uniform(0.1, 1.0, grid.dims), jnp.float32))
    Ke1 = jmg.build_level_ke(mgcfg, young, 1)
    grid1 = mgcfg.levels[1].grid
    u = rng.standard_normal(grid1.nodes_per_dim + (grid1.ndim,)).astype(np.float32)
    ref = pk.apply_k_pallas_cached(jnp.asarray(u), pk.ke_stream_layout(Ke1, grid1),
                                   grid1, interpret=True)
    tgrid1 = _port_grid(grid1)
    stencil = kernels.cached_stencil_plain(torch.tensor(np.asarray(Ke1)), tgrid1)
    assert stencil.shape == kernels.stencil_shape(tgrid1)
    out = kernels.apply_k_cached_f32_plain(torch.tensor(u), stencil, tgrid1)
    assert out.dtype == torch.float32
    assert _rel(out, ref) < 1e-5


@pytest.mark.parametrize("prob_path,dims", CASES)
def test_cached_stencil_twin_matches_apply_k_cached(prob_path, dims):
    """The stencil assembly twin, applied by the apply twin, against the
    JAX ``operators.apply_k_cached`` on a random non-symmetric stack (a
    swapped row and column block would show), in float64: the same K up
    to rounding. Entries of a slot whose neighbour lies outside the grid
    are zero."""
    _, jgrid, rng = _setup(prob_path, dims, jnp.float64, 6)
    grid = _port_grid(jgrid)
    d = grid.nodes_per_elem * grid.ndim
    Ke = rng.standard_normal(grid.dims + (d, d))
    u = rng.standard_normal(grid.nodes_per_dim + (grid.ndim,))
    ref = jops.apply_k_cached(jnp.asarray(u), jnp.asarray(Ke), jgrid)
    stencil = kernels.cached_stencil_plain(torch.tensor(Ke), grid)
    out = kernels.apply_k_cached_f32_plain(torch.tensor(u), stencil, grid)
    assert _rel(out, ref) < 1e-12
    for o, off in enumerate(kernels.stencil_offsets(grid.ndim)):
        for axis, k in enumerate(off):
            if k:  # the first (k = -1) or last (k = +1) node plane has no neighbour
                edge = 0 if k < 0 else grid.nodes_per_dim[axis] - 1
                plane = stencil[o].select(2 + axis, edge)
                assert torch.count_nonzero(plane) == 0


@pytest.mark.parametrize("prob_path,dims", SLOW_CASES)
def test_fine_f64_twin_matches_pallas_df(prob_path, dims):
    """The two-float Pallas kernel's own bound (test_pallas.py) is 2e-10."""
    prob, grid, rng = _setup(prob_path, dims, jnp.float64, 1)
    young64 = np.asarray(prob.young(
        jnp.asarray(rng.uniform(1e-4, 1.0, grid.dims), jnp.float64)))
    u = 1e4 * rng.standard_normal(grid.nodes_per_dim + (grid.ndim,))
    f32 = np.float32
    u_hi = u.astype(f32)
    u_lo = (u - u_hi.astype(np.float64)).astype(f32)
    y_hi = young64.astype(f32)
    y_lo = (young64 - y_hi.astype(np.float64)).astype(f32)
    ref = pk.apply_k_pallas_df(*map(jnp.asarray, (u_hi, u_lo, y_hi, y_lo)),
                               np.asarray(prob.K0), grid, interpret=True)
    out = kernels.apply_k_fine_plain(torch.tensor(u), torch.tensor(young64),
                                     torch.tensor(np.asarray(prob.K0)),
                                     _port_grid(grid))
    assert out.dtype == torch.float64
    assert _rel(out, ref) < 2e-10


def _reflection_apply(B: torch.Tensor, U: torch.Tensor, ndim: int) -> torch.Tensor:
    """K0 U for element DOF columns U (d_pe, E) as the fine kernels compute
    it: Walsh-Hadamard transform over the element's nodes, the 2^N
    reflection blocks, the transform back (B carries the 1/2^N)."""
    npe = 1 << ndim
    V = U.reshape(npe, ndim, -1)
    sign = torch.tensor([[(-1.0) ** bin(t & b).count("1") for b in range(npe)]
                         for t in range(npe)], dtype=U.dtype)
    Vh = torch.einsum("tb,bde->tde", sign, V)
    Wh = torch.zeros_like(Vh)
    for s in range(npe):
        for c in range(ndim):
            for d in range(ndim):
                Wh[s ^ (1 << (ndim - 1 - c)), c] += B[s, c, d] * Vh[s ^ (1 << (ndim - 1 - d)), d]
    return torch.einsum("tb,tde->bde", sign, Wh).reshape(npe * ndim, -1)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.float64, 1e-13)])
@pytest.mark.parametrize("prob_path,dims", CASES + [("problems/3d/bridge.json", (13, 7, 5))])
def test_reflection_blocks_reproduce_k0(prob_path, dims, dtype, tol):
    """The fine kernels' block form of K0 (non-cubic voxels too), in the
    kernels' dtype, reproduces K0 u_e to that dtype's rounding of its
    blocks (applied in float64)."""
    prob, grid, rng = _setup(prob_path, dims, jnp.float64, 7)
    K0 = torch.tensor(np.asarray(prob.K0))
    B = kernels.reflection_blocks(K0, grid.ndim, dtype)
    assert B.dtype == dtype and B.shape == (grid.nodes_per_elem, grid.ndim, grid.ndim)
    U = torch.tensor(rng.standard_normal((K0.shape[0], 64)))
    ref = K0 @ U
    out = _reflection_apply(B.double(), U, grid.ndim)
    assert float((out - ref).abs().max() / ref.abs().max()) < tol


def test_reflection_blocks_refuse_other_k0():
    """A K0 that the element's reflections do not leave invariant (one
    coupling changed) has no block form: the fp32 fine kernel refuses it."""
    prob, grid, _ = _setup(*CASES[1], jnp.float64, 8)
    K0 = torch.tensor(np.asarray(prob.K0))
    K0[0, 5] += 1e-3 * float(K0.abs().max())
    with pytest.raises(ValueError, match="reflections"):
        kernels.reflection_blocks(K0, grid.ndim)


@pytest.mark.parametrize("prob_path,dims", [CASES[0], CASES[1]])
def test_reflection_blocks_hold_float64_to_its_own_bound(prob_path, dims):
    """A coupling outside the blocks of 1e-9 of K0's largest is below the
    fp32 kernels' rounding, so their blocks take it; the float64 kernels,
    held to 1e-12, would drop it, so their blocks refuse it."""
    prob, grid, _ = _setup(prob_path, dims, jnp.float64, 9)
    K0 = torch.tensor(np.asarray(prob.K0))
    K0[0, 4] += 1e-9 * float(K0.abs().max())
    K0[4, 0] = K0[0, 4]
    assert kernels.reflection_blocks(K0, grid.ndim, torch.float32).dtype == torch.float32
    with pytest.raises(ValueError, match="float64 fine kernels"):
        kernels.reflection_blocks(K0, grid.ndim, torch.float64)


@pytest.mark.parametrize("prob_path,dims", [CASES[0], CASES[2]])
def test_float64_block_apply_matches_jax_apply_k(prob_path, dims):
    """The float64 kernels' arithmetic: elements gathered, K0 u_e in the
    reflection basis from the float64 blocks, scaled by young, scattered,
    against the JAX package's ``operators.apply_k`` in float64."""
    prob, jgrid, rng = _setup(prob_path, dims, jnp.float64, 10)
    grid = _port_grid(jgrid)
    young = prob.young(jnp.asarray(rng.uniform(1e-3, 1.0, jgrid.dims)))
    u = 1e3 * rng.standard_normal(grid.nodes_per_dim + (grid.ndim,))
    ref = jops.apply_k(jnp.asarray(u), young, prob.K0, jgrid)
    B = kernels.reflection_blocks(torch.tensor(np.asarray(prob.K0)), grid.ndim,
                                  torch.float64)
    U = tops._gather_dofs(torch.tensor(u), grid)
    F = _reflection_apply(B, U, grid.ndim) * torch.tensor(np.asarray(young)).reshape(-1)
    out = tops._scatter_forces(F.reshape(grid.nodes_per_elem, grid.ndim, *grid.dims), grid)
    assert out.dtype == torch.float64 and np.asarray(ref).dtype == np.float64
    assert _rel(out, ref) < 1e-13


@pytest.mark.parametrize("prob_path,dims", CASES)
def test_wrappers_take_twins_on_cpu(prob_path, dims):
    """A CPU tensor goes to the plain twin: same result, no launch."""
    prob, jgrid, rng = _setup(prob_path, dims, jnp.float32, 4)
    grid = _port_grid(jgrid)
    T = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt)
    young = rng.uniform(0.1, 1.0, grid.dims)
    u = rng.standard_normal(grid.nodes_per_dim + (grid.ndim,))
    K0 = np.asarray(prob.K0)
    d = K0.shape[0]
    Ke = T(rng.standard_normal(grid.dims + (d, d)), torch.float32)
    kernels.reset_launches()
    stencil = kernels.cached_stencil(Ke, grid)
    torch.testing.assert_close(stencil, kernels.cached_stencil_plain(Ke, grid),
                               rtol=0, atol=0)
    for f32, plain, args in [
        (kernels.apply_k_fine_f32, kernels.apply_k_fine_plain,
         (T(u, torch.float32), T(young, torch.float32), T(K0, torch.float32))),
        (kernels.apply_k_fine_f64, kernels.apply_k_fine_plain,
         (T(u, torch.float64), T(young, torch.float64), T(K0, torch.float64))),
        (kernels.apply_k_cached_f32, kernels.apply_k_cached_f32_plain,
         (T(u, torch.float32), stencil)),
    ]:
        torch.testing.assert_close(f32(*args, grid), plain(*args, grid),
                                   rtol=0, atol=0)
    assert kernels.launches == {name: 0 for name in kernels.launches}


def test_wrapper_refuses_other_devices():
    prob, jgrid, rng = _setup(*CASES[1], jnp.float32, 5)
    grid = _port_grid(jgrid)
    u = torch.zeros(grid.nodes_per_dim + (3,), device="meta")
    with pytest.raises(ValueError, match="meta"):
        kernels.apply_k_fine_f32(u, torch.zeros(grid.dims, device="meta"),
                                 torch.zeros(24, 24, device="meta"), grid)
