"""The element-centric fine kernels' twin vs the Pallas kernels they
replace, and the solver's ``fine_kernel`` setting.

``apply_k_fine_elem_f32`` replaces ``apply_k_pallas`` (the "variant" fine
kernel) and ``apply_k_fine_elem_f64`` replaces ``apply_k_pallas_df_flat``
(the "flat" float64 residual). Their plain twin, ``apply_k_fine_plain``,
is held here to each Pallas kernel in interpreter mode, as
``tests/test_pallas.py`` runs them: fp32 within 1e-5 of max|f|
(summation order), float64 within 2e-10 (the two-float kernel's own
bound). The kernels themselves need the card (``tests/test_torch_cuda.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.fem import pallas_kernels as pk
from ndr_tpu.fem.simulator import problem_from_config as j_problem_from_config
from ndr_tpu.io.problem import load_problem
from ndr_tpu_torch.fem import kernels
from ndr_tpu_torch.fem import multigrid as tmg
from ndr_tpu_torch.fem.simulator import problem_from_config as t_problem_from_config
from ndr_tpu_torch.grid import Grid as TGrid
from ndr_tpu_torch.io.problem import load_problem as t_load_problem

MBB = "problems/2d/mbb_beam.json"
CANT = "problems/3d/cantilever_flexion.json"


def _port_grid(grid) -> TGrid:
    """The port's Grid with the fields of a JAX-side Grid."""
    return TGrid(**dataclasses.asdict(grid))


def _rel(out: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(out.double().numpy() - ref).max() / np.abs(ref).max())


# the shapes and slabs of tests/test_pallas.py::test_pallas_apply_k_matches_xla
@pytest.mark.parametrize("prob_path,dims,slab", [
    (MBB, (12, 6), 4),
    (MBB, (10, 7), 5),
    (CANT, (8, 4, 4), 4),
    (CANT, (6, 4, 2), 8),
])
def test_elem_f32_twin_matches_pallas_variant(prob_path, dims, slab):
    prob, grid = j_problem_from_config(load_problem(prob_path), dims=dims,
                                       dtype=jnp.float32)
    rng = np.random.default_rng(0)
    young = np.asarray(prob.young(
        jnp.asarray(rng.uniform(0.1, 1.0, grid.dims), jnp.float32)))
    u = rng.standard_normal(grid.nodes_per_dim + (grid.ndim,)).astype(np.float32)
    ref = pk.apply_k_pallas(jnp.asarray(u), jnp.asarray(young), np.asarray(prob.K0),
                            grid, slab=slab, interpret=True)
    out = kernels.apply_k_fine_plain(torch.tensor(u), torch.tensor(young),
                                     torch.tensor(np.asarray(prob.K0, np.float32)),
                                     _port_grid(grid))
    assert out.dtype == torch.float32
    assert _rel(out, ref) < 1e-5


# the inputs of tests/test_pallas.py::test_pallas_flat_df_apply_matches_float64;
# the interpreted two-float kernel takes ~18 s per 3-D shape on the CPU, so
# one 2-D and one 3-D shape (6x4x2: odd element count along y)
@pytest.mark.parametrize("prob_path,dims", [
    (MBB, (12, 6)),
    (CANT, (6, 4, 2)),
])
def test_elem_f64_twin_matches_pallas_df_flat(prob_path, dims):
    prob, grid = j_problem_from_config(load_problem(prob_path), dims=dims,
                                       dtype=jnp.float64)
    rng = np.random.default_rng(1)
    young64 = np.asarray(prob.young(
        jnp.asarray(rng.uniform(1e-4, 1.0, grid.dims), jnp.float64)))
    u = 1e4 * rng.standard_normal(grid.nodes_per_dim + (grid.ndim,))
    f32 = np.float32
    u_hi = u.astype(f32)
    u_lo = (u - u_hi.astype(np.float64)).astype(f32)
    y_hi = young64.astype(f32)
    y_lo = (young64 - y_hi.astype(np.float64)).astype(f32)
    ref = pk.apply_k_pallas_df_flat(*map(jnp.asarray, (u_hi, u_lo, y_hi, y_lo)),
                                    np.asarray(prob.K0), grid, interpret=True)
    assert np.asarray(ref).dtype == np.float64
    out = kernels.apply_k_fine_plain(torch.tensor(u), torch.tensor(young64),
                                     torch.tensor(np.asarray(prob.K0)),
                                     _port_grid(grid))
    assert out.dtype == torch.float64
    assert _rel(out, ref) < 2e-10


@pytest.mark.parametrize("prob_path,dims", [(MBB, (12, 6)), (CANT, (6, 4, 2))])
def test_elem_wrappers_take_twins_on_cpu(prob_path, dims):
    """A CPU tensor goes to the plain twin: same result, no launch, and no
    block form asked of K0 (this random one has none, which the kernels on
    the card would refuse). The scratch of both kernels, whose geometry
    the card picks, is checked on the card (``tests/test_torch_cuda.py``)."""
    _, grid = t_problem_from_config(t_load_problem(prob_path), dims=dims,
                                    device="cpu")
    rng = np.random.default_rng(4)
    u = torch.tensor(rng.standard_normal(grid.nodes_per_dim + (grid.ndim,)))
    young = torch.tensor(rng.uniform(0.1, 1.0, grid.dims))
    d = grid.nodes_per_elem * grid.ndim
    K0 = torch.tensor(rng.standard_normal((d, d)))
    kernels.reset_launches()
    for fn, dt in [(kernels.apply_k_fine_elem_f32, torch.float32),
                   (kernels.apply_k_fine_elem_f64, torch.float64)]:
        args = (u.to(dt), young.to(dt), K0.to(dt))
        torch.testing.assert_close(fn(*args, grid),
                                   kernels.apply_k_fine_plain(*args, grid),
                                   rtol=0, atol=0)
    assert kernels.launches == {name: 0 for name in kernels.launches}
    with pytest.raises(ValueError, match="float64 fine kernels"):
        kernels.reflection_blocks(K0, grid.ndim, torch.float64)
    f64 = kernels.apply_k_fine_elem_f64(u, young, K0, grid)
    assert f64.dtype == torch.float64 and f64.device.type == "cpu"
    torch.testing.assert_close(f64, kernels.apply_k_fine_plain(u, young, K0, grid),
                               rtol=0, atol=0)
    assert kernels.launches["apply_k_fine_elem_f64"] == 0


def test_fine_kernels_dispatch():
    """The JAX package's NDR_FINE_KERNEL table."""
    k = kernels
    assert k.fine_kernels("flat32") == (k.apply_k_fine_f32, k.apply_k_fine_f64)
    assert k.fine_kernels("variant") == (k.apply_k_fine_elem_f32, k.apply_k_fine_f64)
    assert k.fine_kernels("flat") == (k.apply_k_fine_f32, k.apply_k_fine_elem_f64)
    with pytest.raises(ValueError, match="fine_kernel"):
        k.fine_kernels("elem")


@pytest.mark.parametrize("fine_kernel,f32_name,f64_name", [
    ("flat32", "apply_k_fine_f32", "apply_k_fine_f64"),
    ("variant", "apply_k_fine_elem_f32", "apply_k_fine_f64"),
    ("flat", "apply_k_fine_f32", "apply_k_fine_elem_f64"),
])
def test_fine_kernel_setting_routes_solver(monkeypatch, fine_kernel, f32_name,
                                           f64_name):
    """The refined fp32 solve with kernels on sends every fine fp32 apply
    and every float64 residual to the wrappers ``fine_kernel`` names (their
    twins on the CPU); all three settings give the same solution, since
    the twins are one function."""
    calls = {}
    for name in ("apply_k_fine_f32", "apply_k_fine_elem_f32",
                 "apply_k_fine_f64", "apply_k_fine_elem_f64"):
        def counted(*a, _name=name, _fn=getattr(kernels, name)):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a)
        monkeypatch.setattr(kernels, name, counted)
    prob, grid = t_problem_from_config(t_load_problem(CANT), dims=(16, 8, 8),
                                       dtype=torch.float32, device="cpu")
    rho = torch.tensor(np.random.default_rng(5).uniform(0.05, 1.0, grid.dims),
                       dtype=torch.float32)
    settings = tmg.MGSolverSettings(num_levels=2, smoother="chebyshev",
                                    cheb_degree=1, use_kernels=True,
                                    fine_kernel=fine_kernel)
    u, _ = tmg.make_mg_solver(prob, settings)(rho)
    assert set(calls) == {f32_name, f64_name}
    assert calls[f32_name] > 2 and calls[f64_name] >= 1
    ref, _ = tmg.make_mg_solver(
        prob, dataclasses.replace(settings, fine_kernel="flat32"))(rho)
    torch.testing.assert_close(u, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="fine_kernel"):
        tmg.make_mg_solver(prob, dataclasses.replace(settings, fine_kernel="x"))(rho)
