"""The neural-TO trainer of ndr_tpu_torch vs ``ndr_tpu.training.neural``.

Both packages train the same network (the JAX initial parameters carried
into the port) for 5 steps in float64 on the 2-D MBB beam at 24x8, with
a hard (constrained_sigmoid) and a soft (maxed_barrier) volume
satisfier and with an adaptive-filter schedule. The loss and compliance
histories agree to 2e-13 relative (measured); they are held to 1e-9,
and the CG counts must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.io.problem import load_problem as j_load_problem
from ndr_tpu.ops import filters as jflt
from ndr_tpu.training import neural as jneural
from ndr_tpu_torch.io.problem import load_problem as t_load_problem
from ndr_tpu_torch.models.mlp import params_from_jax
from ndr_tpu_torch.ops import filters as tflt
from ndr_tpu_torch.training import neural as tneural

MBB = "problems/2d/mbb_beam.json"
DIMS = (24, 8)
RTOL = 1e-9
TINY = dict(embedding_size=32, n_neurons=16, n_layers=2, multigrid_levels=1,
            learning_rate=3e-3)


def _metrics(lines):
    """(compliance, loss, cg_iters) of each 'Total Steps' log line."""
    out = []
    for line in lines:
        if line.startswith("Total Steps:"):
            parts = dict(p.strip().rsplit(" ", 1) for p in line.split(",")[1:])
            out.append((float(parts["Compliance loss"]), float(parts["loss"]),
                        int(parts["cg_iters"])))
    return out


def _carried_port_state(tcfg, tncfg, jstate, dims=DIMS):
    """A port trainer state holding the JAX state's network."""
    state, _, _ = tneural.build_trainer(tcfg, tncfg, dims=dims,
                                        dtype=torch.float64, device="cpu")
    state.model.load_state_dict(params_from_jax(jstate.params, jstate.buffers))
    return state


def assert_same_run(jlog, tlog, jhist, thist):
    jm, tm = _metrics(jlog), _metrics(tlog)
    assert len(jm) == len(tm) == len(jhist) == len(thist)
    np.testing.assert_allclose(thist, jhist, rtol=RTOL, atol=0)
    np.testing.assert_allclose([m[0] for m in tm], [m[0] for m in jm], rtol=RTOL)
    np.testing.assert_allclose([m[1] for m in tm], [m[1] for m in jm], rtol=RTOL)
    assert [m[2] for m in tm] == [m[2] for m in jm]


AF = dict(use_projection=True, beta_interval=2, beta_scaler=1.5,
          use_smoothing=True, use_gaussian=True, sigma=0.8)


@pytest.mark.parametrize("vcs,af", [
    ("constrained_sigmoid", None),
    ("maxed_barrier", None),
    ("constrained_sigmoid", AF),
], ids=["hard", "soft", "adaptive-filter"])
def test_trainer_matches_jax(vcs, af):
    kw = dict(TINY, volume_constraint_satisfier=vcs)
    jncfg, tncfg = jneural.NeuralTOConfig(**kw), tneural.NeuralTOConfig(**kw)
    jcfg, tcfg = j_load_problem(MBB), t_load_problem(MBB)
    jstate0, _, _ = jneural.build_trainer(jcfg, jncfg, dims=DIMS, dtype=jnp.float64)
    jlog, tlog = [], []
    jstate, jhist, jaux = jneural.train(
        jcfg, jncfg, dims=DIMS, max_iter=5, log=jlog.append, log_every=1,
        filters=jflt.AdaptiveFilterState(**af) if af else None, dtype=jnp.float64)
    tfilters = tflt.AdaptiveFilterState(**af) if af else None
    tstate, thist, taux = tneural.train(
        tcfg, tncfg, dims=DIMS, max_iter=5, log=tlog.append, log_every=1,
        state=_carried_port_state(tcfg, tncfg, jstate0), filters=tfilters,
        dtype=torch.float64, device="cpu")
    assert_same_run(jlog, tlog, jhist, thist)
    assert tstate.step == int(jstate.step) == 5
    assert len(taux["step_seconds"]) == 5
    if af:
        assert tfilters.beta == 1.5 ** 2
    # the final networks agree
    for i, lyr in enumerate(jstate.params["layers"]):
        w = tstate.model.layers[i].weight.detach().numpy()
        np.testing.assert_allclose(w, np.asarray(lyr["w"]), rtol=1e-8, atol=1e-12)
    rho_t = taux["density_fn"](tstate.model, taux["coords"], taux["max_volume"])
    rho_j = jaux["density_fn"](jstate.params, jstate.buffers, jaux["coords"],
                               jnp.asarray(jcfg.max_volume, jnp.float64))
    np.testing.assert_allclose(rho_t.detach().numpy(), np.asarray(rho_j),
                               rtol=0, atol=1e-9)


def test_trainer_refuses_what_is_not_ported():
    tcfg = t_load_problem(MBB)
    # the chunked loop and the lagged preconditioner are ported: a chunk of
    # 3 steps (4 rounded down to the lag), then 2 in the host loop; builds
    # at steps 0 and 3
    _, hist, aux = tneural.train(tcfg, tneural.NeuralTOConfig(**TINY, precond_lag=3),
                                 dims=DIMS, max_iter=5, scan_chunk=4, device="cpu",
                                 log=lambda s: None)
    assert len(hist) == 5 and np.isfinite(hist).all()
    assert aux["solver_stats"]["hierarchy_builds"] == 2
    # the GS smoother is ported: a GS trainer takes its step
    _, step, _ = tneural.build_trainer(
        tcfg, tneural.NeuralTOConfig(**TINY, smoother="gs"), dims=DIMS, device="cpu")
    state, _, _ = tneural.build_trainer(tcfg, tneural.NeuralTOConfig(**TINY),
                                        dims=DIMS, device="cpu")
    _, metrics = step(state)
    assert bool(torch.isfinite(metrics["compliance"])) and metrics["cg_iters"] > 0
