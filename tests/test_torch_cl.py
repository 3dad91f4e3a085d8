"""Continual learning in ndr_tpu_torch vs the JAX package: the multi-head
MLP, the curriculum's task helpers and the ``train_cl`` trainer.

Float64 on the CPU. Tolerances: the multi-head forward with the JAX
package's activation masks within 1e-12 relative; ``change_scale_value``
and ``prepare_task_values`` exact; ``train_cl`` on MBB 16x8 with the JAX
tests' tiny network (``tests/test_training.py::_tiny_ncfg``), 2 tasks x 5
steps, gate and forget rates 0, started from the JAX package's initial
parameters: compliance histories within 1e-10 relative. The random
helpers draw from other generators than JAX's, so they are held to their
rules: ``uniform > rate`` replaces a weight (probability 1 - rate) and
zeroes a bias, a unit is gated with probability ``rate`` (counts within
3 sigma of the binomial), and a task's masks are drawn once.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu import models as jmodels
from ndr_tpu.io.problem import load_problem as j_load_problem
from ndr_tpu.training import curriculum as jcur
from ndr_tpu.training import neural as jneural
from ndr_tpu.training import train_cl as jcl
from ndr_tpu_torch.io.problem import load_problem as t_load_problem
from ndr_tpu_torch.models import mlp as tmlp
from ndr_tpu_torch.training import curriculum as tcur
from ndr_tpu_torch.training import neural as tneural
from ndr_tpu_torch.training import train_cl as tcl

MBB = "problems/2d/mbb_beam.json"
# tests/test_training.py::_tiny_ncfg
TINY = dict(embedding_size=32, n_neurons=32, n_layers=3, sigma=1.5,
            learning_rate=3e-3, volume_constraint_satisfier="constrained_sigmoid",
            multigrid_levels=1, cg_tol=1e-5)


def _jax_multihead(n_heads=2, es=16, nn=24, nl=3, seed=0):
    cfg = jmodels.MLPConfig(in_features=2, out_features=1, n_neurons=nn, n_layers=nl,
                            embedding_size=es, scale=1.0)
    params, buffers = jmodels.init_multihead_mlp(jax.random.PRNGKey(seed), cfg, n_heads,
                                                 jnp.float64)
    tcfg = tmlp.MLPConfig(in_features=2, out_features=1, n_neurons=nn, n_layers=nl,
                          embedding_size=es, scale=1.0)
    model = tmlp.MultiHeadMLP(tcfg, n_heads, dtype=torch.float64, device="cpu")
    model.load_state_dict(tmlp.params_from_jax(params, buffers))
    return cfg, params, buffers, model


def test_multihead_apply_with_masks_matches_jax():
    cfg, params, buffers, model = _jax_multihead()
    buffers = jmodels.change_scale_value(buffers, 2.5)
    tmlp.change_scale_value(model, 2.5)
    masks = jcur.make_activation_masks(jax.random.PRNGKey(3), params["trunk"], 0.4)
    x = np.random.default_rng(0).uniform(0, 1, (7, 5, 2))
    tmasks = [torch.tensor(np.asarray(m)) for m in masks]
    for head in (0, 1):
        for jm, tm in ((None, None), (masks, tmasks)):
            yj = np.asarray(jmodels.multihead_apply(params, buffers, jnp.asarray(x), head, cfg,
                                                    activation_masks=jm))
            yt = tmlp.multihead_apply(model, torch.tensor(x), head,
                                      activation_masks=tm).detach().numpy()
            assert yt.shape == yj.shape == (7, 5, 1)
            np.testing.assert_allclose(yt, yj, rtol=1e-12, atol=1e-12 * np.abs(yj).max())
    # the masks gate something: the gated output differs
    y0 = tmlp.multihead_apply(model, torch.tensor(x), 0)
    y1 = tmlp.multihead_apply(model, torch.tensor(x), 0, activation_masks=tmasks)
    assert not torch.allclose(y0, y1)


def test_single_head_mlp_apply_with_masks_matches_jax():
    cfg = jmodels.MLPConfig(in_features=2, n_neurons=24, n_layers=3, embedding_size=16,
                            scale=2.0)
    params, buffers = jmodels.init_mlp(jax.random.PRNGKey(1), cfg, jnp.float64)
    model = tmlp.FourierFeatureMLP(
        tmlp.MLPConfig(in_features=2, n_neurons=24, n_layers=3, embedding_size=16,
                       scale=2.0), dtype=torch.float64, device="cpu")
    model.load_state_dict(tmlp.params_from_jax(params, buffers))
    masks = jcur.make_activation_masks(jax.random.PRNGKey(4), params, 0.3)
    assert len(masks) == 2
    x = np.random.default_rng(2).uniform(0, 1, (11, 2))
    yj = np.asarray(jmodels.mlp_apply(params, buffers, jnp.asarray(x), cfg,
                                      activation_masks=masks))
    yt = tmlp.mlp_apply(model, torch.tensor(x),
                        activation_masks=[torch.tensor(np.asarray(m)) for m in masks])
    np.testing.assert_allclose(yt.detach().numpy(), yj, rtol=1e-12,
                               atol=1e-12 * np.abs(yj).max())


def test_change_scale_value_matches_jax():
    _, _, buffers, model = _jax_multihead()
    B0 = model.B.clone()
    for scale in (4.0, 2.0, 1.5):
        buffers = jmodels.change_scale_value(buffers, scale)
        tmlp.change_scale_value(model, scale)
        np.testing.assert_array_equal(model.B.numpy(), np.asarray(buffers["B"]))
        assert float(model.old_scale) == float(buffers["old_scale"]) == scale
    np.testing.assert_allclose(model.B.numpy(), 1.5 * B0.numpy(), rtol=1e-15)


def test_init_multihead_mlp_semantics():
    cfg = tmlp.MLPConfig(in_features=3, n_neurons=64, n_layers=3, embedding_size=16)
    model = tmlp.init_multihead_mlp(cfg, 3, torch.Generator().manual_seed(0),
                                    dtype=torch.float64, device="cpu")
    assert len(model.trunk) == 2 and len(model.heads) == 3
    assert model.trunk[0].weight.shape == (64, 32) and model.heads[0].weight.shape == (1, 64)
    assert float(model.old_scale) == 1.0
    gain2 = 64 / 16  # orthogonal rows (out <= in) or columns, times the gain
    w = model.trunk[1].weight.detach()
    np.testing.assert_allclose((w @ w.t()).numpy(), gain2 * np.eye(64), atol=1e-12)
    h = model.heads[2].weight.detach()
    np.testing.assert_allclose(float(h @ h.t()), gain2, rtol=1e-12)
    assert all(float(lyr.bias.detach().abs().max()) == 0.0 for lyr in model.trunk)


@pytest.mark.parametrize("order", ["ctf", "ftc"])
def test_prepare_task_values_matches_jax(order):
    for kw in (dict(interval=1.5, start=0, end=3), dict(interval=2, start=1, end=5)):
        np.testing.assert_array_equal(tcur.prepare_task_values(order=order, **kw),
                                      jcur.prepare_task_values(order=order, **kw))
    shuffled = tcur.prepare_task_values(interval=1, start=0, end=10, order="random",
                                        generator=torch.Generator().manual_seed(0))
    assert sorted(shuffled.tolist()) == list(range(10))


def test_forget_weights_rule():
    rate, n = 0.3, 200
    lin = torch.nn.Linear(n, n, dtype=torch.float64)
    with torch.no_grad():
        lin.weight.fill_(5.0)
        lin.bias.fill_(5.0)
    tcur.forget_weights(torch.Generator().manual_seed(0), lin, rate, mode="constant",
                        constant_value=0.25)
    w, b = lin.weight.detach(), lin.bias.detach()
    replaced = int((w == 0.25).sum())
    assert replaced + int((w == 5.0).sum()) == n * n
    p = 1.0 - rate
    assert abs(replaced - p * n * n) < 3 * np.sqrt(n * n * p * (1 - p))
    zeroed = int((b == 0.0).sum())
    assert zeroed + int((b == 5.0).sum()) == n
    assert abs(zeroed - p * n) < 3 * np.sqrt(n * p * (1 - p))
    # the other modes draw new values where the rule replaces
    for mode in ("orthogonal", "normal", "uniform"):
        w2 = torch.full((64, 32), 5.0, dtype=torch.float64)
        tcur.forget_weights(torch.Generator().manual_seed(1), [w2], rate, mode=mode)
        kept = int((w2 == 5.0).sum())
        assert abs(kept - rate * 2048) < 3 * np.sqrt(2048 * rate * (1 - rate))
        if mode == "uniform":
            assert float(w2[w2 != 5.0].abs().max()) <= 1.0
    with pytest.raises(NotImplementedError):
        tcur.forget_weights(torch.Generator(), lin, rate, mode="bogus")


def test_make_activation_masks_rule():
    cfg = tmlp.MLPConfig(n_neurons=400, n_layers=4, embedding_size=16)
    model = tmlp.init_multihead_mlp(cfg, 1, torch.Generator().manual_seed(0),
                                    dtype=torch.float64, device="cpu")
    rate = 0.2
    masks = tcur.make_activation_masks(torch.Generator().manual_seed(2), model, rate)
    assert [m.shape for m in masks] == [(400,)] * 3 and masks[0].dtype == torch.bool
    gated = sum(int((~m).sum()) for m in masks)
    assert abs(gated - rate * 1200) < 3 * np.sqrt(1200 * rate * (1 - rate))
    single = tmlp.init_mlp(cfg, torch.Generator().manual_seed(0), dtype=torch.float64,
                           device="cpu")
    assert len(tcur.make_activation_masks(torch.Generator(), single, rate)) == 3


def test_masks_drawn_once_per_task(monkeypatch):
    calls = []
    real = tcur.make_activation_masks

    def spy(gen, layers, rate):
        calls.append(rate)
        return real(gen, layers, rate)

    monkeypatch.setattr(tcur, "make_activation_masks", spy)
    cfg = t_load_problem(MBB)
    ncfg = tneural.NeuralTOConfig(**dict(TINY, embedding_size=8, n_neurons=8))
    clcfg = tcl.CLConfig(task_interval=1.5, task_end=2, iters_per_task=3,
                         activation_gate_rate=0.2, forget_rate=0.1)
    model, hist, aux = tcl.train_cl(cfg, ncfg, clcfg, dims=(8, 4), log=lambda s: None,
                                    device="cpu")
    assert calls == [0.2, 0.2]
    assert [len(h) for h in hist] == [3, 3] and np.isfinite(np.concatenate(hist)).all()
    assert float(model.old_scale) == aux["sigmas"][-1] == 3.0
    assert [len(s) for s in aux["step_seconds"]] == [3, 3]


# The hard satisfier removes every constant shift of the output, so the
# gradient of the head's bias (and of a trunk unit active at every point)
# is rounding alone, which Adam scales up to a step of up to lr: the
# port's own run moves by 4.1e-10 when one weight matrix is scaled by
# 1 + 1e-15 (measured). So constrained_sigmoid is held to 1e-8 (measured
# 9.7e-10 against JAX) and maxed_barrier, with no such direction, to 1e-10
# (measured ~1e-13).
@pytest.mark.parametrize("vcs,rtol", [("constrained_sigmoid", 1e-8),
                                      ("maxed_barrier", 1e-10)])
def test_train_cl_matches_jax(vcs, rtol):
    jcfg, tcfg = j_load_problem(MBB), t_load_problem(MBB)
    kw = dict(TINY, volume_constraint_satisfier=vcs)
    jncfg = jneural.NeuralTOConfig(**kw)
    clkw = dict(task_interval=1.5, task_end=2, iters_per_task=5)
    _, _, jhist, jaux = jcl.train_cl(jcfg, jncfg, jcl.CLConfig(**clkw), dims=(16, 8),
                                     log=lambda s: None, dtype=jnp.float64)
    # the JAX trainer's initial network (train_cl's own key split)
    _, k_init = jax.random.split(jax.random.PRNGKey(jncfg.seed))
    params, buffers = jmodels.init_multihead_mlp(k_init, jaux["mlp_cfg"], 2, jnp.float64)
    mcfg = tmlp.MLPConfig(in_features=2, out_features=1, n_neurons=32, n_layers=3,
                          embedding_size=32, scale=1.0)
    model = tmlp.MultiHeadMLP(mcfg, 2, dtype=torch.float64, device="cpu")
    model.load_state_dict(tmlp.params_from_jax(params, buffers))
    log = []
    model, thist, taux = tcl.train_cl(tcfg, tneural.NeuralTOConfig(**kw),
                                      tcl.CLConfig(**clkw), dims=(16, 8),
                                      log=log.append, log_every=1, dtype=torch.float64,
                                      device="cpu", model=model)
    assert taux["sigmas"] == jaux["sigmas"] == [1.5, 3.0]
    assert [len(h) for h in thist] == [len(h) for h in jhist] == [5, 5]
    np.testing.assert_allclose(np.concatenate(thist), np.concatenate(jhist), rtol=rtol)
    for h in thist:
        assert h[-1] < h[0]
    assert sum(line.startswith("Task 1 step") for line in log) == 5


def test_cli_writes_artifacts(tmp_path):
    argv = ["--prob", MBB, "--grid", "[12, 4]", "--mgl", "1", "--es", "8", "--nn", "8",
            "--nl", "2", "--iter", "2", "--task-end", "2", "--task-interval", "1.5",
            "--gate-rate", "0.2", "--forget-rate", "0.1", "--device", "cpu",
            "--out", str(tmp_path), "--jid", "cl"]
    model, histories, aux = tcl.main(argv)
    for t in range(2):
        rho = np.load(tmp_path / f"cl_task{t}_densities.npy")
        assert rho.shape == (12, 4) and np.isfinite(rho).all()
        assert os.path.exists(tmp_path / f"cl_task{t}.vtr")
    with open(tmp_path / "cl_history.json") as f:
        rec = json.load(f)
    assert rec["sigmas"] == [1.0, 2.5] and [len(h) for h in rec["histories"]] == [2, 2]
    assert rec["histories"] == histories
    if not torch.cuda.is_available():  # no silent CPU run
        with pytest.raises(RuntimeError, match="is_available"):
            tcl.main(argv + ["--device", "cuda"])
