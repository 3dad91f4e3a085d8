"""The model zoo, datasets and history of ndr_tpu_torch vs the JAX package.

Float64 on the CPU. SIREN, the CNN generator and the deconv generator
carry the JAX package's initial parameters across (``tree_state_dict``)
and their forward passes agree within 1e-12 relative (measured ~1e-15);
the port's own inits keep the JAX init's bounds and laws. ``datasets``
and ``utils.history`` agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu import models as jmodels
from ndr_tpu.models import cnn as jcnn
from ndr_tpu.training import datasets as jdata
from ndr_tpu.utils import history as jhist
from ndr_tpu_torch import models as tmodels
from ndr_tpu_torch.training import datasets as tdata
from ndr_tpu_torch.utils import history as thist

RTOL = 1e-12


def _close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("outermost_linear", [True, False])
def test_siren_matches_jax(outermost_linear):
    kw = dict(in_features=2, hidden_features=32, hidden_layers=2,
              outermost_linear=outermost_linear)
    params = jmodels.init_siren(jax.random.PRNGKey(0), jmodels.SirenConfig(**kw), jnp.float64)
    model = tmodels.Siren(tmodels.SirenConfig(**kw), dtype=torch.float64, device="cpu")
    model.load_state_dict(tmodels.tree_state_dict(params))
    x = np.random.default_rng(0).uniform(-1, 1, (9, 7, 2))
    _close(tmodels.siren_apply(model, torch.tensor(x)),
           jmodels.siren_apply(params, jnp.asarray(x), jmodels.SirenConfig(**kw)))


def test_siren_init_bounds():
    cfg = tmodels.SirenConfig()
    model = tmodels.init_siren(cfg, torch.Generator().manual_seed(0), dtype=torch.float64,
                               device="cpu")
    assert len(model.layers) == cfg.hidden_layers + 2
    w0 = model.layers[0]["w"].detach()
    assert float(w0.abs().max()) <= 1.0 / cfg.in_features
    bound = np.sqrt(6.0 / cfg.hidden_features) / cfg.hidden_omega_0
    for lyr in list(model.layers)[1:]:
        assert float(lyr["w"].detach().abs().max()) <= bound
        assert float(lyr["b"].detach().abs().max()) <= 1.0 / np.sqrt(cfg.hidden_features)
    assert float(w0.abs().max()) > 0.9 / cfg.in_features  # spread over the bound


CNN_SMALL = dict(grid_dims=(16, 8), latent_size=8, dense_channels=4, resizes=(1, 2, 2, 1),
                 conv_filters=(8, 8, 4, 1))


@pytest.mark.parametrize("kw", [CNN_SMALL, dict(CNN_SMALL, offset_scale=0.0)],
                         ids=["offsets", "no-offsets"])
def test_cnn_matches_jax(kw):
    jcfg = jmodels.CNNConfig(**kw)
    params = jmodels.init_cnn(jax.random.PRNGKey(0), jcfg, jnp.float64)
    # non-zero offsets, so that they enter
    params["offsets"] = [o + 0.01 * jax.random.normal(jax.random.PRNGKey(i), o.shape, o.dtype)
                         for i, o in enumerate(params["offsets"])]
    model = tmodels.CNNGenerator(tmodels.CNNConfig(**kw), dtype=torch.float64, device="cpu")
    model.load_state_dict(tmodels.tree_state_dict(params))
    _close(tmodels.cnn_apply(model), jmodels.cnn_apply(params, jcfg))
    z = np.random.default_rng(0).standard_normal(jcfg.latent_size)
    _close(tmodels.cnn_apply(model, torch.tensor(z)),
           jmodels.cnn_apply(params, jcfg, jnp.asarray(z)))


def test_deconv_matches_jax():
    jcfg = jcnn.DeconvConfig(design=(20, 12))
    params = jcnn.init_deconv_generator(jax.random.PRNGKey(0), jcfg, jnp.float64)
    model = tmodels.DeconvGenerator(tmodels.DeconvConfig(design=(20, 12)),
                                    dtype=torch.float64, device="cpu")
    model.load_state_dict(tmodels.tree_state_dict(params))
    z = np.random.default_rng(1).standard_normal((15, 1))
    out = tmodels.deconv_generator_apply(model, torch.tensor(z))
    assert out.shape == (20, 12)
    _close(out, jcnn.deconv_generator_apply(params, jcfg, jnp.asarray(z)))


def test_default_generators_and_backward():
    """The default configs build, run forward and backward on the CPU."""
    gen = torch.Generator().manual_seed(0)
    cnn = tmodels.init_cnn(tmodels.CNNConfig(), gen, dtype=torch.float64, device="cpu")
    out = tmodels.cnn_apply(cnn)
    assert out.shape == (40, 16)  # (40, 20) // prod(resizes) * prod(resizes)
    out.sum().backward()
    assert all(p.grad is not None for p in cnn.parameters())
    dec = tmodels.init_deconv_generator(tmodels.DeconvConfig(), gen, dtype=torch.float64,
                                        device="cpu")
    z = tdata.random_field(gen, 675, dtype=torch.float64, device="cpu")
    assert tmodels.deconv_generator_apply(dec, z).shape == (180, 60)
    dense = cnn.dense["w"].detach()
    np.testing.assert_allclose((dense.t() @ dense).numpy(),
                               (dense.shape[0] / 128) * np.eye(128), atol=1e-10)


def test_datasets_and_history_match_jax(tmp_path):
    for flatten in (False, True):
        np.testing.assert_array_equal(
            tdata.mesh_grid((5, 3), flatten=flatten, dtype=torch.float64, device="cpu"),
            np.asarray(jdata.mesh_grid((5, 3), flatten=flatten, dtype=jnp.float64)))
    dom = [(-1.0, 2.0), (0.0, 0.5), (1.0, 3.0)]
    np.testing.assert_allclose(
        tdata.mesh_grid((4, 3, 2), domain=dom, dtype=torch.float64, device="cpu").numpy(),
        np.asarray(jdata.mesh_grid((4, 3, 2), domain=dom, dtype=jnp.float64)), atol=1e-15)
    gt = np.random.default_rng(0).uniform(size=(3, 5)).astype(np.float32)
    np.save(tmp_path / "gt.npy", gt)
    ct, gtt = tdata.supervised_mesh_grid((5, 3), str(tmp_path / "gt.npy"),
                                         dtype=torch.float64, device="cpu")
    cj, gtj = jdata.supervised_mesh_grid((5, 3), str(tmp_path / "gt.npy"), dtype=jnp.float64)
    np.testing.assert_array_equal(gtt.numpy(), np.asarray(gtj))
    gen = torch.Generator().manual_seed(0)
    z = tdata.normal_latent(gen, 1000, std=2.0, mean=1.0, dtype=torch.float64, device="cpu")
    assert z.shape == (1000,) and abs(float(z.mean()) - 1.0) < 0.25
    assert abs(float(z.std()) - 2.0) < 0.25
    # count_parameters: a module, and a JAX-style tree of tensors
    cfg = jmodels.SirenConfig(hidden_features=16, hidden_layers=1)
    params = jmodels.init_siren(jax.random.PRNGKey(0), cfg, jnp.float64)
    tree = {k: [{n: torch.tensor(np.asarray(a)) for n, a in lyr.items()} for lyr in v]
            for k, v in params.items()}
    model = tmodels.Siren(tmodels.SirenConfig(hidden_features=16, hidden_layers=1),
                          device="cpu")
    assert tdata.count_parameters(model) == tdata.count_parameters(tree) \
        == jdata.count_parameters(params)
    # history
    rng = np.random.default_rng(0)
    fields = [rng.uniform(size=(4, 3)) for _ in range(7)]
    ht, hj = thist.OptimizationHistory(), jhist.OptimizationHistory()
    for i, f in enumerate(fields):
        ht.update(f, 10.0 - i)
        hj.update(f, 10.0 - i)
    st, sj = ht.subsample(3), hj.subsample(3)
    assert st.iter == sj.iter and st.objective == sj.objective
    assert st.nondiscreteness == sj.nondiscreteness
    assert thist.upscale_scalar_field((4, 3), fields[0])[0] == (8, 6)
    for fn in ("upscale_scalar_field", "downscale_scalar_field"):
        np.testing.assert_array_equal(getattr(thist, fn)((4, 3), fields[0])[1],
                                      getattr(jhist, fn)((4, 3), fields[0])[1])
    assert thist.numerical_derivative(np.sin, 0.3, 1e-5, 1.0) == \
        jhist.numerical_derivative(np.sin, 0.3, 1e-5, 1.0)
