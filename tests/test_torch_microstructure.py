"""Microstructure design of ndr_tpu_torch vs ``ndr_tpu.fem.microstructure``.

Float64 on the CPU. Ten Adam steps at lr 0.3 on an 8x8 cell from the same
numpy-seeded start, with the smoothness and integrality regularizers on:
the distance history within 1e-9 relative and the final density within
1e-8 (measured: 4e-15 and 2e-15; the optimizers are optax's and torch's
Adam, the same update). Then the JAX test's laminate recovery
(``tests/test_homogenization.py::test_microstructure_design_matches_target``)
on the port alone: 150 steps to a distance below 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.fem import element as jel
from ndr_tpu.fem import homogenization as jhom
from ndr_tpu.fem import microstructure as jms
from ndr_tpu.grid import make_grid as j_make_grid
from ndr_tpu_torch.fem import element as tel
from ndr_tpu_torch.fem import homogenization as thom
from ndr_tpu_torch.fem import microstructure as tms
from ndr_tpu_torch.grid import Grid as TGrid


def _setup(dims=(8, 8)):
    jg = j_make_grid(dims, [[0] * len(dims), [1] * len(dims)])
    tg = TGrid(**dataclasses.asdict(jg))
    return (jg, tg, jel.IsotropicMaterial(1.0, 0.3, jg.ndim),
            tel.IsotropicMaterial(1.0, 0.3, jg.ndim))


@pytest.mark.parametrize("reg", [dict(), dict(smoothness_weight=0.1, binary_weight=0.05,
                                              volume_target=0.5, volume_weight=1.0)],
                         ids=["match-only", "regularized"])
def test_design_matches_jax(reg):
    jg, tg, jm, tm = _setup()
    lam, mu = jm.lame
    target = jhom.isotropic_voigt(0.5 * lam, 0.5 * mu, 2)
    rho0 = np.random.default_rng(0).uniform(0.3, 0.7, jg.dims)
    kw = dict(steps=10, learning_rate=0.3, log=lambda s: None, **reg)
    rj = jms.design_microstructure(target, jg, jm, rho0=jnp.asarray(rho0), **kw)
    rt = tms.design_microstructure(target, tg, tm, rho0=torch.tensor(rho0), **kw)
    assert len(rt.history) == len(rj.history) == 10
    np.testing.assert_allclose(rt.history, rj.history, rtol=1e-9)
    np.testing.assert_allclose(rt.rho, np.asarray(rj.rho), rtol=0, atol=1e-8)
    np.testing.assert_allclose(rt.Eh, np.asarray(rj.Eh), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(rj.Eh)).max())
    assert float(tms.tensor_distance(torch.tensor(rt.Eh), target)) >= 0.0


def test_design_recovers_laminate():
    _, grid, _, mat = _setup()
    K0 = torch.tensor(tel.element_stiffness_matrix((1, 1), grid.stretchings, mat))
    rho_t = torch.ones(grid.dims, dtype=torch.float64)
    rho_t[:4] = 0.3
    w = thom.solve_cell_problems(rho_t, grid, mat, K0, tol=1e-11)
    target = thom.homogenized_elasticity_tensor(w, rho_t, grid, mat, K0)
    rho0 = torch.tensor(np.random.default_rng(0).uniform(0.3, 0.7, grid.dims))
    res = tms.design_microstructure(target, grid, mat, rho0=rho0, steps=150,
                                    learning_rate=0.3, log=lambda s: None)
    assert res.history[-1] < 1e-4, res.history[-1]
    assert res.rho.shape == grid.dims and res.Eh.shape == (3, 3)


def test_default_start_is_on_the_card():
    _, grid, _, mat = _setup((2, 2))
    if not torch.cuda.is_available():  # no silent CPU run
        with pytest.raises((RuntimeError, AssertionError)):
            tms.design_microstructure(np.eye(3), grid, mat, steps=1, log=lambda s: None)
    res = tms.design_microstructure(np.eye(3), grid, mat, steps=2, device="cpu",
                                    log=lambda s: None)
    assert len(res.history) == 2 and res.rho.dtype == np.float64
