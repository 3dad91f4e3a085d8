"""Field calculus (ndr_tpu_torch.ops.calculus) against the closed forms of
tests/test_calculus.py, against the JAX package on the port's MLP carried
across by ``params_from_jax``, and the parameter-size helpers
(ndr_tpu_torch.utils.memory) against the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu import models as jmodels
from ndr_tpu.ops import calculus as jcalc
from ndr_tpu.utils import memory as jmemory
from ndr_tpu_torch.models import mlp as tmlp
from ndr_tpu_torch.ops import calculus
from ndr_tpu_torch.utils import memory


def _coords2(n=7):
    rng = np.random.default_rng(0)
    return torch.tensor(rng.uniform(-1.0, 1.0, size=(n, 2)))


def test_gradient_closed_form():
    # f = x^2 y + sin(y); grad = (2xy, x^2 + cos(y))
    f = lambda p: p[0] ** 2 * p[1] + torch.sin(p[1])
    c = _coords2()
    g = calculus.gradient(f)(c)
    x, y = c[:, 0].numpy(), c[:, 1].numpy()
    np.testing.assert_allclose(g.numpy(), np.stack([2 * x * y, x ** 2 + np.cos(y)], -1),
                               rtol=1e-12)


def test_gradient_batch_shape():
    f = lambda p: torch.sum(p ** 3)
    c = _coords2(12).reshape(3, 4, 2)
    g = calculus.gradient(f)(c)
    assert g.shape == (3, 4, 2)
    np.testing.assert_allclose(g.numpy(), 3 * c.numpy() ** 2, rtol=1e-12)


def test_divergence_closed_form():
    # v = (x^2, xy); div = 3x
    v = lambda p: torch.stack([p[0] ** 2, p[0] * p[1]])
    c = _coords2()
    np.testing.assert_allclose(calculus.divergence(v)(c).numpy(), 3 * c[:, 0].numpy(),
                               rtol=1e-12)


def test_laplacian_matches_div_of_grad():
    f = lambda p: p[0] ** 2 - p[1] ** 2 + p[0] ** 4   # lap = 12 x^2
    c = _coords2()
    lap = calculus.laplacian(f)(c)
    np.testing.assert_allclose(lap.numpy(), 12 * c[:, 0].numpy() ** 2, rtol=1e-12)
    div_of_grad = calculus.divergence(torch.func.grad(f))(c)
    np.testing.assert_allclose(lap.numpy(), div_of_grad.numpy(), rtol=1e-12)
    assert calculus.laplace is calculus.laplacian


def _carried_mlp(in_features):
    cfg = jmodels.MLPConfig(in_features=in_features, out_features=1, n_neurons=16,
                            n_layers=3, embedding_size=8, scale=1.5)
    params, buffers = jmodels.init_mlp(jax.random.PRNGKey(3), cfg, jnp.float64)
    tcfg = tmlp.MLPConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(tmlp.MLPConfig)})
    model = tmlp.FourierFeatureMLP(tcfg, dtype=torch.float64, device="cpu")
    model.load_state_dict(tmlp.params_from_jax(params, buffers))
    return cfg, params, buffers, model


@pytest.mark.parametrize("op", ["gradient", "laplacian"])
@pytest.mark.parametrize("in_features", [2, 3])
def test_mlp_field_derivatives_match_jax(op, in_features):
    """The density field of the MLP, carried across from JAX parameters:
    its gradient and Laplacian at random points, within 1e-10."""
    cfg, params, buffers, model = _carried_mlp(in_features)
    x = np.random.default_rng(4).uniform(0.0, 1.0, (5, 3, in_features))
    jf = lambda p: jmodels.mlp_apply(params, buffers, p[None], cfg)[0, 0]
    tf = lambda p: tmlp.mlp_apply(model, p[None])[0, 0]
    ref = np.asarray(getattr(jcalc, op)(jf)(jnp.asarray(x)))
    out = getattr(calculus, op)(tf)(torch.tensor(x)).detach().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-10 * max(np.abs(ref).max(), 1.0))


def test_param_bytes_and_estimate_size():
    cfg, params, buffers, model = _carried_mlp(2)
    # the frozen Fourier matrix is a buffer in both packages, not a parameter
    assert memory.param_bytes(model) == jmemory.param_bytes(params)
    assert memory.param_bytes({"w": [torch.zeros(3, 4), torch.zeros(5)]}) == 4 * 17
    x = torch.zeros((64, 2), dtype=torch.float64)
    est = memory.estimate_size(lambda xx: tmlp.mlp_apply(model, xx), x)
    assert est == {}  # CPU tensors: no allocator statistics
