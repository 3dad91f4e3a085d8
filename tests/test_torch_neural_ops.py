"""The neural-TO building blocks of ndr_tpu_torch vs the JAX package, in
float64 on the CPU: the Fourier-feature MLP (with carried parameters),
``find_root`` and the volume satisfiers, the training-side filters with
their adaptive schedule, and the curriculum schedules.

Tolerances: the MLP and filters are the same arithmetic in another
summation order (1e-12); ``find_root``'s value and implicit gradient are
held to 1e-10 (the bisection stops at a 1e-12 bracket).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu import models as jmodels
from ndr_tpu.ops import filters as jflt
from ndr_tpu.ops import volume as jvol
from ndr_tpu.training import curriculum as jcur
from ndr_tpu_torch.models import mlp as tmlp
from ndr_tpu_torch.ops import filters as tflt
from ndr_tpu_torch.ops import volume as tvol
from ndr_tpu_torch.training import curriculum as tcur


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _carried_mlp(in_features=3, out_act=None, seed=0):
    cfg = jmodels.MLPConfig(in_features=in_features, out_features=1,
                            n_neurons=16, n_layers=3, embedding_size=8,
                            scale=1.5, output_activation=out_act)
    params, buffers = jmodels.init_mlp(jax.random.PRNGKey(seed), cfg, jnp.float64)
    params = jmodels.homogeneous_init(params, 0.4)
    tcfg = tmlp.MLPConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(tmlp.MLPConfig)})
    model = tmlp.FourierFeatureMLP(tcfg, dtype=torch.float64, device="cpu")
    model.load_state_dict(tmlp.params_from_jax(params, buffers))
    return cfg, params, buffers, model


@pytest.mark.parametrize("out_act", [None, "sigmoid"])
def test_mlp_forward_matches_jax(out_act):
    """Unchunked, and chunked with a small max_points (ragged last chunk)."""
    cfg, params, buffers, model = _carried_mlp(out_act=out_act)
    x = np.random.default_rng(0).uniform(0, 1, (5, 4, 3, 3))
    ref = np.asarray(jmodels.mlp_apply(params, buffers, jnp.asarray(x), cfg))
    out = tmlp.mlp_apply(model, torch.tensor(x))
    assert out.shape == ref.shape and _rel(out.detach(), ref) < 1e-12
    ref_c = np.asarray(jmodels.mlp_apply_chunked(params, buffers, jnp.asarray(x),
                                                 cfg, max_points=16))
    out_c = tmlp.mlp_apply_chunked(model, torch.tensor(x), max_points=16)
    assert _rel(out_c.detach(), ref_c) < 1e-12
    assert _rel(out_c.detach(), ref) < 1e-12


def test_mlp_chunked_backward_is_unchunked_gradient():
    _, _, _, model = _carried_mlp()
    x = torch.tensor(np.random.default_rng(1).uniform(0, 1, (7, 5, 3)))
    w = torch.tensor(np.random.default_rng(2).standard_normal((7, 5, 1)))
    grads = []
    for max_points in (1 << 17, 8):
        model.zero_grad()
        (tmlp.mlp_apply_chunked(model, x, max_points=max_points) * w).sum().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for g_full, g_chunk in zip(*grads):
        torch.testing.assert_close(g_chunk, g_full, rtol=1e-12, atol=1e-14)


def test_mlp_init_and_homogeneous_init():
    cfg = tmlp.MLPConfig(in_features=2, n_neurons=16, n_layers=3,
                         embedding_size=8, scale=2.0)
    a = tmlp.init_mlp(cfg, torch.Generator().manual_seed(3), torch.float64, "cpu")
    b = tmlp.init_mlp(cfg, torch.Generator().manual_seed(3), torch.float64, "cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert "B" in dict(a.named_buffers()) and "B" not in dict(a.named_parameters())
    gain = np.sqrt(max(16 / 8, 1.0))
    w0 = a.layers[0].weight                      # (16, 16): orthogonal * gain
    torch.testing.assert_close(w0 @ w0.t(), gain ** 2 * torch.eye(16, dtype=torch.float64))
    assert all(float(l.bias.detach().abs().max()) == 0 for l in a.layers)
    tmlp.homogeneous_init(a, 0.3)
    assert float(a.layers[-1].weight.detach().abs().max()) < 1e-3
    with torch.no_grad():
        out = a(torch.rand(4, 2, dtype=torch.float64))
    torch.testing.assert_close(out, torch.full_like(out, 0.3), rtol=0, atol=5e-3)


_PROJECTIONS = {
    "sigmoid": (jax.nn.sigmoid, torch.sigmoid),
    "tanh": (lambda v: 0.5 * jnp.tanh(1.7 * v) + 0.5,
             lambda v: 0.5 * torch.tanh(1.7 * v) + 0.5),
}


@pytest.mark.parametrize("proj", sorted(_PROJECTIONS))
def test_find_root_value_and_gradient_match_jax(proj):
    jp, tp = _PROJECTIONS[proj]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 5))
    g = rng.standard_normal((6, 5))
    target = 0.35

    def jloss(xx):
        return jnp.sum(jp(xx + jvol.find_root(xx, target, jp)) * g)

    ref_b = float(jvol.find_root(jnp.asarray(x), target, jp))
    ref_grad = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    ref_db = np.asarray(jax.grad(lambda xx: jvol.find_root(xx, target, jp))(
        jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    b = tvol.find_root(xt, target, tp)
    assert abs(float(b.detach()) - ref_b) < 1e-10
    (db,) = torch.autograd.grad(b, xt, retain_graph=True)
    assert _rel(db, ref_db) < 1e-10
    (grad,) = torch.autograd.grad((tp(xt + b) * torch.tensor(g)).sum(), xt)
    assert _rel(grad, ref_grad) < 1e-10
    # the constrained mean holds
    assert abs(float(tp(xt + b).mean()) - target) < 1e-10


@pytest.mark.parametrize("mode", ["constrained_sigmoid", "constrained_projection",
                                  "add_mean", "one_sided_max", "maxed_barrier",
                                  "thresholded_barrier"])
def test_satisfy_volume_constraint_matches_jax(mode):
    """Value and gradient of every mode; soft modes with a compliance
    term whose scaler is clipped (the trainer's 'clip' mode)."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0.05, 0.95, (5, 4))
    w = rng.standard_normal((5, 4))
    hard = jvol.is_hard_mode(mode)
    assert tvol.is_hard_mode(mode) == hard

    def jf(xx):
        c = jnp.sum(xx * w) ** 2
        out = jvol.satisfy_volume_constraint(xx, 0.3, compliance_loss=c, mode=mode,
                                             constant=7.0, beta=2.0)
        return jnp.sum(out * w) if hard else out + c

    def tf(xx):
        c = (xx * torch.tensor(w)).sum() ** 2
        out = tvol.satisfy_volume_constraint(xx, 0.3, compliance_loss=c, mode=mode,
                                             constant=7.0, beta=2.0)
        return (out * torch.tensor(w)).sum() if hard else out + c

    ref_v, ref_g = jax.value_and_grad(jf)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    v = tf(xt)
    (g,) = torch.autograd.grad(v, xt)
    assert abs(float(v) - float(ref_v)) <= 1e-10 * max(abs(float(ref_v)), 1.0)
    assert _rel(g, ref_g) < 1e-10
    with pytest.raises(ValueError):
        tvol.is_hard_mode("volume")


@pytest.mark.parametrize("shape", [(7, 5), (3, 2), (1, 4), (4, 3, 2)])
def test_training_filters_match_jax(shape):
    """Reflect padding including pads as wide as or wider than the axis."""
    x = np.random.default_rng(6).uniform(0, 1, shape)
    xj, xt = jnp.asarray(x), torch.tensor(x)
    for beta in (1.0, 3.5):
        for norm in (False, True):
            assert _rel(tflt.projection_filter(xt, beta, normalized=norm),
                        jflt.projection_filter(xj, beta, normalized=norm)) < 1e-12
    for r in (1, 2, 4):
        assert _rel(tflt.smoothing_filter(xt, r), jflt.smoothing_filter(xj, r)) < 1e-12
    for sigma in (0.5, 1.0, 1.7):
        assert _rel(tflt.gaussian_filter(xt, sigma), jflt.gaussian_filter(xj, sigma)) < 1e-12
        assert tflt.gaussian_kernel_size(sigma) == jflt.gaussian_kernel_size(sigma)
    assert _rel(tflt.gaussian_kernel_1d(5, 1.3, torch.float64, "cpu"),
                jflt.gaussian_kernel_1d(5, 1.3)) < 1e-15


def test_adaptive_filter_schedule_matches_jax():
    kw = dict(use_projection=True, beta_interval=2, beta_scaler=1.5,
              use_smoothing=True, radius=2.0, radius_interval=3, radius_scaler=0.5,
              use_gaussian=True, sigma=1.2, sigma_interval=4, sigma_scaler=1.25)
    fj, ft = jflt.AdaptiveFilterState(**kw), tflt.AdaptiveFilterState(**kw)
    x = np.random.default_rng(7).uniform(-0.5, 0.5, (9, 6))
    for i in range(9):
        assert _rel(ft.apply(torch.tensor(x)), fj.apply(jnp.asarray(x))) < 1e-12
        fj.update(i)
        ft.update(i)
        assert (ft.beta, ft.radius, ft.sigma) == (fj.beta, fj.radius, fj.sigma)
    fj.reset(beta=2.0)
    ft.reset(beta=2.0)
    assert (ft.beta, ft.radius, ft.sigma) == (fj.beta, fj.radius, fj.sigma) == (2.0, 1.0, 1.0)


def test_curriculum_schedules_match_jax():
    for kw in (dict(interval=4, start=0, end=3, order="ctf"),
               dict(interval=5, start=1, end=4, order="ftc", repeat_res=2)):
        np.testing.assert_array_equal(tcur.prepare_resolutions(**kw),
                                      jcur.prepare_resolutions(**kw))
    for mode in ("constant", "linear_inc", "linear_dec", "linear_abs"):
        for n in (4, 5):
            assert (tcur.prepare_epoch_sizes(n, 100, 400, mode, 250)
                    == jcur.prepare_epoch_sizes(n, 100, 400, mode, 250))
    # random modes draw from the explicit generator
    a = tcur.prepare_resolutions(3, 0, 6, "random", generator=np.random.default_rng(8))
    b = tcur.prepare_resolutions(3, 0, 6, "random", generator=np.random.default_rng(8))
    np.testing.assert_array_equal(a, b)
    assert sorted(a) == [0, 3, 6, 9, 12, 15]
    e = tcur.prepare_epoch_sizes(6, 100, 400, "random", generator=np.random.default_rng(9))
    assert e == tcur.prepare_epoch_sizes(6, 100, 400, "random",
                                         generator=np.random.default_rng(9))
    assert all(100 <= v < 400 for v in e)
