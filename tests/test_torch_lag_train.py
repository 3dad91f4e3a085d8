"""The trainers' lagged preconditioner and chunked loop: ndr_tpu_torch vs
the JAX package.

Classic SIMP-OC on the 2-D MBB beam at 24x8 (mgl=1) and neural TO on the
tiny network of tests/test_training.py run through both packages in
float64 with the same options: ``scan_chunk`` (the port's chunked loop,
the JAX package's ``lax.scan``), ``precond_lag`` (the host loop's lag and
its early rebuild) and both together (blocks of ``lag`` steps inside a
chunk). The histories agree to rounding (held to 1e-9, measured ~1e-12)
with equal CG counts.

From the uniform start the first OC step moves every density by the move
limit, and the hierarchy built before it stalls CG at its cap on the next
step, in both packages (the stale coarse operator is off by the SIMP
modulus change, up to ~5x). A stalled CG amplifies rounding, so the runs
with a lag start from the design of 20 fresh OC steps, where a hierarchy
one step old converges (two steps old, it stalls there too, so no chunk
here holds a block longer than 2); the stall itself is held to the JAX
package's step by step until the step where it occurs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.io.problem import load_problem
from ndr_tpu.training import neural as jneural
from ndr_tpu.training.classic import ground_truth_topopt as j_gt
from ndr_tpu_torch.fem import multigrid as tmg
from ndr_tpu_torch.io.problem import load_problem as t_load_problem
from ndr_tpu_torch.models.mlp import params_from_jax
from ndr_tpu_torch.training import neural as tneural
from ndr_tpu_torch.training.classic import ground_truth_topopt as t_gt

MBB = "problems/2d/mbb_beam.json"
RTOL = 1e-9
KW = dict(dims=(24, 8), multigrid_levels=1)


def _cg_counts(lines):
    return [int(l.rsplit("cg_iters ", 1)[1]) for l in lines if "cg_iters" in l]


def _both(max_iter, init=None, **opts):
    """(JAX result, port result, JAX CG counts, port CG counts)."""
    jlog, tlog = [], []
    rj = j_gt(load_problem(MBB), max_iter=max_iter, dtype=jnp.float64, init=init,
              log=jlog.append, **KW, **opts)
    rt = t_gt(t_load_problem(MBB), max_iter=max_iter, dtype=torch.float64, init=init,
              device="cpu", log=tlog.append, **KW, **opts)
    return rj, rt, _cg_counts(jlog), _cg_counts(tlog)


@pytest.fixture(scope="module")
def design20():
    """The design after 20 fresh float64 OC steps (the port's run)."""
    return t_gt(t_load_problem(MBB), max_iter=20, dtype=torch.float64, device="cpu",
                log=lambda s: None, **KW).densities


def test_classic_scan_chunk_matches_jax():
    """Two chunks of 4 steps plus a remainder of 2 in the host loop; no lag:
    every step builds its hierarchy (the port's chunk rebuilds into one
    state per step)."""
    rj, rt, cj, ct = _both(10, scan_chunk=4)
    np.testing.assert_allclose(rt.history, rj.history, rtol=RTOL, atol=0)
    assert ct == cj
    assert rt.compliance == pytest.approx(rj.compliance, rel=RTOL)
    assert rt.solver_stats["hierarchy_builds"] == 10


@pytest.mark.parametrize("opts,builds", [
    (dict(precond_lag=3), None),
    # a chunk of 4 = two blocks of lag 2, then 2 host-loop steps
    (dict(scan_chunk=4, precond_lag=2), 4),
    # the chunk rounded down to a multiple of the lag (4), then 4 host-loop
    # steps that rebuild every 2
    (dict(scan_chunk=5, precond_lag=2), 4),
], ids=["lag3", "scan4-lag2", "scan5-lag2"])
def test_classic_lag_matches_jax(design20, opts, builds):
    rj, rt, cj, ct = _both(8, init=design20, **opts)
    np.testing.assert_allclose(rt.history, rj.history, rtol=RTOL, atol=0)
    assert ct == cj and max(ct) < 100
    assert rt.binary_compliance == pytest.approx(rj.binary_compliance, rel=RTOL)
    if builds is not None:
        assert rt.solver_stats["hierarchy_builds"] == builds


def test_classic_lag_stall_matches_jax():
    """From the uniform start the first lagged solve stalls at the CG cap
    in both packages; up to that step the runs agree, and the early
    rebuild follows on the next step."""
    rj, rt, cj, ct = _both(3, precond_lag=3)
    assert ct[:2] == cj[:2] and ct[1] == 100
    np.testing.assert_allclose(rt.history[:1], rj.history[:1], rtol=RTOL, atol=0)
    # step 0 builds, step 1 stalls (100 > 4 + 4), step 2 rebuilds early
    assert rt.solver_stats["hierarchy_builds"] == 2


def test_classic_early_rebuild_on_cg_jump(monkeypatch):
    """A CG count more than 4 above the first lagged solve's rebuilds the
    hierarchy on the next step, before the lag runs out; inside a chunk no
    early rebuild happens."""
    make = tmg.make_mg_solver
    builds, calls = [], []

    def counted_solver(prob, settings):
        solve = make(prob, settings)

        def jumpy(rho, u0=None, precond=None):
            u, _ = solve(rho, u0, precond=precond)
            calls.append(len(calls))
            return u, 15 if len(calls) == 2 else 5  # the second solve jumps

        def build(rho, into=None, use_graph=False):
            builds.append(len(calls))
            return solve.build_precond(rho, into=into, use_graph=use_graph)

        jumpy.cfg, jumpy.settings, jumpy.build_precond = solve.cfg, solve.settings, build
        return jumpy

    monkeypatch.setattr(tmg, "make_mg_solver", counted_solver)
    cfg = t_load_problem(MBB)
    kw = dict(max_iter=6, dtype=torch.float64, device="cpu", log=lambda s: None, **KW)
    t_gt(cfg, precond_lag=5, **kw)
    # built before solves 0 (the start) and 2 (after the jump), then after 5 more
    assert builds == [0, 2]
    builds.clear()
    calls.clear()
    t_gt(cfg, precond_lag=5, scan_chunk=5, **kw)
    # the chunk builds once at its start; the remainder step builds its own
    assert builds == [0, 5]


NCFG = dict(embedding_size=32, n_neurons=32, n_layers=3, sigma=1.5,
            learning_rate=3e-3, volume_constraint_satisfier="constrained_sigmoid",
            multigrid_levels=1, cg_tol=1e-5)


@pytest.mark.parametrize("scan", [0, 8], ids=["host-loop", "scan8"])
def test_neural_lag_matches_jax(scan):
    """``precond_lag=4`` (rebuild when step % 4 == 0), as a host loop and
    as one chunk of two blocks; the port carries JAX's initial network."""
    dims = (16, 8)
    jcfg, tcfg = load_problem(MBB), t_load_problem(MBB)
    jn = jneural.NeuralTOConfig(**NCFG, precond_lag=4)
    tn = tneural.NeuralTOConfig(**NCFG, precond_lag=4)
    jstate0, _, _ = jneural.build_trainer(jcfg, jn, dims=dims, dtype=jnp.float64)
    jlog, tlog = [], []
    _, jhist, _ = jneural.train(jcfg, jn, dims=dims, max_iter=8, log=jlog.append,
                                log_every=1, dtype=jnp.float64, scan_chunk=scan)
    state, _, _ = tneural.build_trainer(tcfg, tn, dims=dims, dtype=torch.float64,
                                        device="cpu")
    state.model.load_state_dict(params_from_jax(jstate0.params, jstate0.buffers))
    _, thist, aux = tneural.train(tcfg, tn, dims=dims, max_iter=8, log=tlog.append,
                                  log_every=1, state=state, dtype=torch.float64,
                                  device="cpu", scan_chunk=scan)
    np.testing.assert_allclose(thist, jhist, rtol=RTOL, atol=0)
    assert _cg_counts(tlog) == _cg_counts(jlog)
    assert aux["solver_stats"]["hierarchy_builds"] == 2
    assert len(aux["step_seconds"]) == 8
