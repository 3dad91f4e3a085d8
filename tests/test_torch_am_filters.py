"""The additive-manufacturing (Langelaar) and callback filters:
ndr_tpu_torch vs the JAX package, in float64.

Forward and vector-Jacobian product on the same random fields (numpy
seed), held to 1e-12: both are the same elementwise layer sweep, summed
in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.ops import filters as jflt
from ndr_tpu_torch.ops import filters as tflt

SHAPES = [(6, 5), (6, 5, 7), (4, 3, 9)]


def _vjp_both(jf, tf, x, w):
    yj, pull = jax.vjp(jf, jnp.asarray(x))
    gj, = pull(jnp.asarray(w))
    xt = torch.tensor(x, requires_grad=True)
    yt = tf(xt)
    gt, = torch.autograd.grad(yt, xt, torch.tensor(w))
    return (np.asarray(yj), yt.detach().numpy()), (np.asarray(gj), gt.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_langelaar_forward_and_vjp_match_jax(shape):
    rng = np.random.default_rng(7)
    x = rng.uniform(0.02, 1.0, shape)
    w = rng.standard_normal(shape)
    (yj, yt), (gj, gt) = _vjp_both(jflt.LangelaarFilter().apply,
                                   tflt.LangelaarFilter().apply, x, w)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-12 * np.abs(gj).max())
    # the first layer prints as designed; no layer gets (much) denser
    np.testing.assert_array_equal(yt[..., 0], x[..., 0])
    assert (yt <= x + 1e-2).all()


def test_langelaar_parameters_carry_over():
    rng = np.random.default_rng(8)
    x = rng.uniform(0.02, 1.0, (5, 4, 6))
    w = rng.standard_normal(x.shape)
    kw = dict(P=12.0, Q=10.5, epsilon=1e-3)
    (yj, yt), (gj, gt) = _vjp_both(jflt.LangelaarFilter(**kw).apply,
                                   tflt.LangelaarFilter(**kw).apply, x, w)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-12 * np.abs(gj).max())


def test_callback_filter_in_a_chain_matches_jax():
    """A CallbackFilter (here a squared field) between smoothing and
    projection: the chain's forward and VJP through the callable."""
    rng = np.random.default_rng(9)
    x = rng.uniform(0.0, 1.0, (7, 5, 4))
    w = rng.standard_normal(x.shape)
    jchain = [jflt.SmoothingFilter(1), jflt.CallbackFilter(fn=lambda v: v * v),
              jflt.ProjectionFilter(2.0)]
    tchain = [tflt.SmoothingFilter(1), tflt.CallbackFilter(fn=lambda v: v * v),
              tflt.ProjectionFilter(2.0)]
    (yj, yt), (gj, gt) = _vjp_both(lambda v: jflt.apply_filter_chain(v, jchain),
                                   lambda v: tflt.apply_filter_chain(v, tchain), x, w)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-12)


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("shape", [(7, 5), (6, 5, 7)])
def test_smoothing_filter_forward_and_vjp_match_jax(shape, radius):
    """The clipped box mean and its transpose, a pooling of the cotangent
    over the count (gathered, not added with atomics): forward the same
    bits as torch's pooling, the VJP within 1e-14 of JAX's and of
    autograd through torch's pooling."""
    rng = np.random.default_rng(10)
    x = rng.uniform(0.0, 1.0, shape)
    w = rng.standard_normal(shape)
    (yj, yt), (gj, gt) = _vjp_both(jflt.SmoothingFilter(radius).apply,
                                   tflt.SmoothingFilter(radius).apply, x, w)
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-14)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-14 * np.abs(gj).max())
    pool = {2: torch.nn.functional.avg_pool2d, 3: torch.nn.functional.avg_pool3d}[len(shape)]
    xt = torch.tensor(x, requires_grad=True)
    yp = pool(xt[None, None], 2 * radius + 1, 1, radius, count_include_pad=False)[0, 0]
    gp, = torch.autograd.grad(yp, xt, torch.tensor(w))
    np.testing.assert_array_equal(yt, yp.detach().numpy())
    np.testing.assert_allclose(gt, gp.numpy(), rtol=0, atol=1e-14 * np.abs(gj).max())
