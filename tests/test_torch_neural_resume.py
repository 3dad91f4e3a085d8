"""Multiresolution training, checkpoints and the ``train_xdg`` CLI of
ndr_tpu_torch, against the JAX package where it has a counterpart.

  * a two-stage ``train_multires`` (24x8 then 30x10 on the MBB beam)
    from the same network matches ``ndr_tpu``'s in float64 (held to 1e-9;
    measured ~2e-13);
  * a checkpoint written by ``ndr_tpu.utils.checkpoint.save_checkpoint``
    after 3 steps loads into the port (weights, B and the Adam state),
    and 3 more steps from it match JAX continuing from the same file;
    the port's own checkpoint reads back into JAX unchanged;
  * the CLI writes every artifact at CPU size and refuses what is not
    ported.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.io.problem import load_problem as j_load_problem
from ndr_tpu.training import neural as jneural
from ndr_tpu.utils import checkpoint as jckpt
from ndr_tpu_torch.io.problem import load_problem as t_load_problem
from ndr_tpu_torch.models.mlp import params_from_jax
from ndr_tpu_torch.training import neural as tneural
from ndr_tpu_torch.training import train_xdg
from ndr_tpu_torch.utils import checkpoint as tckpt

MBB = "problems/2d/mbb_beam.json"
DIMS = (24, 8)
RTOL = 1e-9
TINY = dict(embedding_size=32, n_neurons=16, n_layers=2, multigrid_levels=1,
            learning_rate=3e-3, volume_constraint_satisfier="constrained_sigmoid")


def _quiet(s):
    pass


def _configs(**kw):
    return (j_load_problem(MBB), t_load_problem(MBB),
            jneural.NeuralTOConfig(**dict(TINY, **kw)),
            tneural.NeuralTOConfig(**dict(TINY, **kw)))


def test_multires_matches_jax():
    jcfg, tcfg, jn, tn = _configs()
    jstate0, _, _ = jneural.build_trainer(jcfg, jn, dims=DIMS, dtype=jnp.float64)
    deltas, sizes = [0, 2], [3, 2]
    jlog, tlog = [], []
    jstate, jhist, _ = jneural.train_multires(
        jcfg, jn, DIMS, deltas, sizes, log=jlog.append, log_every=1,
        dtype=jnp.float64)
    tstate, _, _ = tneural.build_trainer(tcfg, tn, dims=DIMS, dtype=torch.float64,
                                         device="cpu")
    tstate.model.load_state_dict(params_from_jax(jstate0.params, jstate0.buffers))
    tstate, thist, taux = tneural.train_multires(
        tcfg, tn, DIMS, deltas, sizes, log=tlog.append, log_every=1,
        dtype=torch.float64, device="cpu", state=tstate)
    assert [l for l in tlog if l.startswith("New resolution")] == \
        [l for l in jlog if l.startswith("New resolution")] == \
        ["New resolution within multires loop: (24, 8)\n",
         "New resolution within multires loop: (30, 10)\n"]
    assert len(thist) == len(jhist) == 5 and tstate.step == int(jstate.step) == 5
    np.testing.assert_allclose(thist, jhist, rtol=RTOL, atol=0)
    assert taux["grid"].dims == (30, 10) and len(taux["step_seconds"]) == 5


def test_resume_from_jax_checkpoint_matches_jax(tmp_path):
    jcfg, tcfg, jn, tn = _configs(weight_decay=1e-3)
    path = str(tmp_path / "jax.npz")
    jstate, _, _ = jneural.train(jcfg, jn, dims=DIMS, max_iter=3, log=_quiet,
                                 dtype=jnp.float64)
    jckpt.save_checkpoint(path, jstate.params, jstate.buffers, jn.sigma,
                          step=int(jstate.step), opt_state=jstate.opt_state)

    # JAX continues from the file, as its CLI's --checkpoint does
    js0, _, _ = jneural.build_trainer(jcfg, jn, dims=DIMS, dtype=jnp.float64)
    params, buffers, sigma, step, opt = jckpt.load_checkpoint(
        path, js0.params, js0.buffers, js0.opt_state)
    js0 = dataclasses.replace(js0, params=params, buffers=buffers, opt_state=opt,
                              step=jnp.asarray(step, jnp.int32))
    jstate, jhist, _ = jneural.train(jcfg, jn, dims=DIMS, max_iter=3, log=_quiet,
                                     state=js0, dtype=jnp.float64)

    ts0, _, _ = tneural.build_trainer(tcfg, tn, dims=DIMS, dtype=torch.float64,
                                      device="cpu")
    assert isinstance(ts0.optimizer, torch.optim.AdamW)
    tsigma, tstep = tckpt.load_checkpoint(path, ts0.model, ts0.optimizer)
    assert (tsigma, tstep) == (sigma, step) == (jn.sigma, 3)
    first = ts0.model.layers[0]
    np.testing.assert_array_equal(first.weight.detach().numpy(),
                                  np.asarray(params["layers"][0]["w"]))
    st = ts0.optimizer.state[first.weight]
    assert int(st["step"]) == 3
    np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                  np.asarray(opt[0].nu["layers"][0]["w"]))
    ts0.step = tstep
    tstate, thist, _ = tneural.train(tcfg, tn, dims=DIMS, max_iter=3, log=_quiet,
                                     state=ts0, dtype=torch.float64, device="cpu")
    assert tstate.step == int(jstate.step) == 6
    np.testing.assert_allclose(thist, jhist, rtol=RTOL, atol=0)

    # the port's file is the JAX layout: it reads back into JAX as written
    out = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(out, tstate.model, tn.sigma, step=tstate.step,
                          optimizer=tstate.optimizer)
    params, buffers, sigma, step, opt = jckpt.load_checkpoint(
        out, js0.params, js0.buffers, js0.opt_state)
    assert (sigma, step) == (tn.sigma, 6) and int(opt[0].count) == 6
    np.testing.assert_array_equal(np.asarray(buffers["B"]), tstate.model.B.numpy())
    np.testing.assert_array_equal(
        np.asarray(opt[0].mu["layers"][1]["b"]),
        tstate.optimizer.state[tstate.model.layers[1].bias]["exp_avg"].numpy())


def test_async_checkpointer_writes_in_order_and_raises(tmp_path):
    _, tcfg, _, tn = _configs()
    state, _, _ = tneural.build_trainer(tcfg, tn, dims=DIMS, device="cpu")
    saver = tckpt.AsyncCheckpointer()
    saver.save(str(tmp_path / "a.npz"), state.model, 1.0, step=1)
    with torch.no_grad():
        state.model.layers[0].bias.add_(1.0)   # after save(): not in a.npz
    saver.save(str(tmp_path / "b.npz"), state.model, 1.0, step=2,
               optimizer=state.optimizer)
    saver.wait()
    with np.load(tmp_path / "a.npz") as a, np.load(tmp_path / "b.npz") as b:
        np.testing.assert_array_equal(a["params/layers/0/b"] + 1.0, b["params/layers/0/b"])
        assert "opt/0/count" in b.files and int(b["opt/0/count"]) == 0
    saver.save(str(tmp_path / "missing" / "dir" / "\0bad.npz"), state.model, 1.0)
    with pytest.raises(ValueError):
        saver.wait()


def test_cli_cpu_smoke(tmp_path, capsys):
    out = tmp_path / "out"
    result = train_xdg.main([
        "--device", "cpu", "--prob", MBB, "--grid", "[24,8]", "--mgl", "1",
        "--iter", "4", "--es", "32", "--nn", "16", "--nl", "2",
        "--vcs", "constrained_sigmoid", "--out", str(out), "--jid", "smoke",
        "--log-every", "1", "--cs", "2"])
    err = capsys.readouterr().err
    lines = [l for l in err.splitlines() if l.startswith("Total Steps:")]
    assert len(lines) == 4 and lines[0].startswith("Total Steps: 1, Compliance loss ")
    assert all(", loss " in l and ", cg_iters " in l for l in lines)
    assert "Resolution runtime: " in err
    assert "Final compliance " in err and ", binary " in err and "b-vol=" in err
    for f in ("smoke.vtr", "smoke_densities.npy", "smoke.npz", "smoke_history.json",
              "smoke_iter1.npz", "smoke_iter3.npz"):
        assert (out / f).exists(), f
    hist = json.loads((out / "smoke_history.json").read_text())
    assert len(hist["history"]) == len(hist["step_seconds"]) == 4
    assert np.isfinite(hist["final_compliance"]) and np.isfinite(hist["binary_compliance"])
    assert np.load(out / "smoke_densities.npy").shape == (24, 8)
    assert result.history == hist["history"]
    # --checkpoint resumes the network, its Adam state and the step count
    train_xdg.main([
        "--device", "cpu", "--prob", MBB, "--grid", "[24,8]", "--mgl", "1",
        "--iter", "1", "--es", "32", "--nn", "16", "--nl", "2",
        "--vcs", "constrained_sigmoid", "--out", str(out), "--jid", "again",
        "--checkpoint", str(out / "smoke.npz")])
    err = capsys.readouterr().err
    assert "Resumed checkpoint at step 4" in err and "Total Steps: 5," in err


def test_cli_refuses_what_is_not_ported(tmp_path):
    base = ["--prob", MBB, "--grid", "[24,8]", "--iter", "1", "--es", "8",
            "--nn", "8", "--nl", "2", "--out", str(tmp_path)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_xdg.main(base)          # --device defaults to cuda
    # the chunked loop and the lagged preconditioner are ported
    for extra in (["--scan", "2"], ["--precond-lag", "2"]):
        result = train_xdg.main(base[:5] + ["2"] + base[6:] + ["--device", "cpu"] + extra)
        assert len(result.history) == 2 and np.isfinite(result.history).all()
    # the GS smoother is ported
    result = train_xdg.main(base + ["--device", "cpu", "--mgl", "1", "--smoother", "gs"])
    assert np.isfinite(result.final_compliance)
    with pytest.raises(SystemExit):
        train_xdg.main(base + ["--device", "cpu", "--fine-kernel", "elem"])
