"""The lagged preconditioner built from the training step's own forward
pass: ``neural.train`` against the schedule that built it from a forward
pass of its own before the step (``aux["density_fn"]``, then
``aux["solve"].build_precond`` and ``train_step(state, precond=...)``), on
the CPU.

Both schedules read the same network at the same parameters on the same
coordinates, so the preconditioner, the CG counts, the losses and the
final parameters agree to the bit. The 2-D MBB beam at 16x8 runs through
a tiny network whose forward goes through the checkpointed chunks (64
points a chunk), in float64 and float32: the chunked loop at lag 0 (a
build before every step) and the host loop at lag 2.
"""

import functools

import pytest
import torch

from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.models import mlp
from ndr_tpu_torch.training import neural

MBB = "problems/2d/mbb_beam.json"
DIMS = (16, 8)


def _config(lag):
    return neural.NeuralTOConfig(embedding_size=16, n_neurons=16, n_layers=2,
                                 multigrid_levels=2, use_kernels=False, precond_lag=lag)


def _separate_forward(cfg, ncfg, steps, block, dtype):
    """The parent schedule: a forward pass of its own before each step
    that starts a block of ``block`` steps, the preconditioner built in
    place from it."""
    state, train_step, aux = neural.build_trainer(cfg, ncfg, dims=DIMS, dtype=dtype,
                                                  device="cpu")
    metrics, precond = [], None
    for i in range(steps):
        if i % block == 0:
            with torch.no_grad():
                rho = aux["density_fn"](state.model, aux["coords"], aux["max_volume"])
                precond = aux["solve"].build_precond(rho, into=precond)
        state, m = train_step(state, precond=precond)
        metrics.append(m)
    return state, metrics


def _from_step(cfg, ncfg, steps, scan_chunk, dtype, monkeypatch):
    """``neural.train``, every step's metrics recorded."""
    build_trainer, metrics = neural.build_trainer, []

    def recording(*args, **kwargs):
        state, train_step, aux = build_trainer(*args, **kwargs)

        def step(state, **kw):
            state, m = train_step(state, **kw)
            metrics.append(m)
            return state, m
        return state, step, aux

    monkeypatch.setattr(neural, "build_trainer", recording)
    state, _, aux = neural.train(cfg, ncfg, dims=DIMS, max_iter=steps, dtype=dtype,
                                 device="cpu", log=lambda s: None, scan_chunk=scan_chunk)
    return state, metrics, aux["solver_stats"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("scan_chunk,lag,steps", [(4, 0, 4), (0, 2, 5)],
                         ids=["scan_chunk", "host_loop_lag"])
def test_build_from_step_matches_separate_forward(monkeypatch, scan_chunk, lag, steps,
                                                  dtype):
    monkeypatch.setattr(mlp, "mlp_apply_chunked",
                        functools.partial(mlp.mlp_apply_chunked, max_points=64))
    cfg, ncfg = load_problem(MBB), _config(lag)
    block = lag or 1
    ref_state, ref = _separate_forward(cfg, ncfg, steps, block, dtype)
    state, got, st = _from_step(cfg, ncfg, steps, scan_chunk, dtype, monkeypatch)
    assert st["mlp_forwards"] == steps
    assert st["neural.precond_from_step"] == st["hierarchy_builds"] == -(-steps // block)
    assert [int(m["cg_iters"]) for m in got] == [int(m["cg_iters"]) for m in ref]
    for key in ("loss", "compliance"):
        assert all(torch.equal(m[key], r[key]) for m, r in zip(got, ref)), key
    for (name, p), q in zip(state.model.named_parameters(), ref_state.model.parameters()):
        assert torch.equal(p, q), name
    assert torch.equal(state.u, ref_state.u)
