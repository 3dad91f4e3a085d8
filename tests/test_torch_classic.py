"""The classic SIMP-OC slice end to end: ndr_tpu_torch vs the JAX package.

``ground_truth_topopt`` runs through both packages on the same problem.
In float64 the trajectories agree to rounding. In the default fp32 mode
with float64 refinement, every solve agrees to ~1e-6, but the OC
bisection on the fp32 volume constraint is noise-limited (|c| <= 1e-6 is
met over a range of lambda): from the same state the two packages land
on lambdas up to ~2e-4 apart, so trajectories drift. The 3-D cantilever
stays within 1e-5 over 4 steps; the 2-D MBB, whose single corner support
makes it the most sensitive, drifts to 2.2e-4 over 6 steps, so it is held
to 5e-4. The continuation test holds each fp32 step from a JAX state to
1e-5 in compliance and equilibrium, and asserts the lambda and x gaps
that make up the drift.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.fem import multigrid as jmg
from ndr_tpu.fem import topopt as jtopopt
from ndr_tpu.fem.simulator import problem_from_config as j_problem_from_config
from ndr_tpu.io.problem import load_problem
from ndr_tpu.ops import filters as jflt
from ndr_tpu.training.classic import ground_truth_topopt as j_gt
from ndr_tpu_torch.fem import multigrid as tmg
from ndr_tpu_torch.fem import topopt as ttopopt
from ndr_tpu_torch.fem.simulator import problem_from_config as t_problem_from_config
from ndr_tpu_torch.io.problem import load_problem as t_load_problem
from ndr_tpu_torch.ops import filters as tflt
from ndr_tpu_torch.training import train_voxelfem
from ndr_tpu_torch.training.classic import ground_truth_topopt as t_gt

MBB = "problems/2d/mbb_beam.json"
CANT = "problems/3d/cantilever_flexion.json"
_quiet = lambda s: None


@pytest.mark.parametrize("prob_path,dims,mgl,iters,f64,rtol", [
    (MBB, (24, 8), 1, 6, True, 1e-6),
    (MBB, (24, 8), 1, 6, False, 5e-4),
    (CANT, (16, 8, 8), 2, 4, True, 1e-6),
    (CANT, (16, 8, 8), 2, 4, False, 1e-4),
    # mgl=0: plain block-Jacobi CG (the reference's exact-solve path)
    (MBB, (24, 8), 0, 3, True, 1e-6),
    # 25x8 cannot coarsen: make_mg_solver falls back to block-Jacobi PCG
    (MBB, (25, 8), 1, 3, True, 1e-6),
], ids=["mbb-f64", "mbb-f32", "cantilever-f64", "cantilever-f32",
        "mbb-mgl0-f64", "mbb25x8-jacobi-f64"])
def test_classic_matches_jax(prob_path, dims, mgl, iters, f64, rtol):
    rj = j_gt(load_problem(prob_path), dims=dims, max_iter=iters,
              multigrid_levels=mgl, dtype=jnp.float64 if f64 else None,
              log=_quiet)
    rt = t_gt(t_load_problem(prob_path), dims=dims, max_iter=iters, multigrid_levels=mgl,
              dtype=torch.float64 if f64 else None, device="cpu", log=_quiet)
    hj, ht = np.asarray(rj.history), np.asarray(rt.history)
    assert ht.shape == hj.shape == (iters,)
    np.testing.assert_allclose(ht, hj, rtol=rtol, atol=0)
    assert rt.compliance == pytest.approx(rj.compliance, rel=rtol)
    assert rt.binary_compliance == pytest.approx(rj.binary_compliance, rel=rtol)
    assert rt.densities.shape == rt.physical.shape == tuple(dims)
    assert rt.densities.dtype == (np.float64 if f64 else np.float32)


def _both_problems(prob_path, dims, mgl, f64):
    cfg = load_problem(prob_path)
    pj, grid = j_problem_from_config(cfg, dims=dims,
                                     dtype=jnp.float64 if f64 else jnp.float32)
    pt, _ = t_problem_from_config(t_load_problem(prob_path), dims=dims,
                                  dtype=torch.float64 if f64 else torch.float32,
                                  device="cpu")
    kw = dict(num_levels=mgl, smoother="chebyshev", cheb_degree=1)
    tj = jtopopt.TopologyOptimizationProblem(
        pj, [jflt.SmoothingFilter(1), jflt.ProjectionFilter(1.0)],
        cfg.max_volume, jmg.make_mg_solver(pj, jmg.MGSolverSettings(**kw)))
    tt = ttopopt.TopologyOptimizationProblem(
        pt, [tflt.SmoothingFilter(1), tflt.ProjectionFilter(1.0)],
        cfg.max_volume, tmg.make_mg_solver(pt, tmg.MGSolverSettings(**kw)))
    x0 = jnp.full(grid.dims, cfg.max_volume, jnp.float64 if f64 else jnp.float32)
    return tj, tt, jtopopt.oc_init(tj, x0, u_dtype=jnp.float64)


def _carry(state):
    return ttopopt.oc_state_from_numpy(
        {f: np.asarray(getattr(state, f))
         for f in ("x", "u", "lambda_min", "lambda_max")}, device="cpu")


def test_continuation_from_jax_state_f64():
    """JAX runs 2 steps; both packages continue 3 steps from its state."""
    tj, tt, sj = _both_problems(CANT, (16, 8, 8), 2, f64=True)
    step = jax.jit(lambda s: jtopopt.oc_step(tj, s))
    for _ in range(2):
        sj, _ = step(sj)
    st = _carry(sj)
    for k in range(3):
        sj, mj = step(sj)
        st, mt = ttopopt.oc_step(tt, st)
        assert mt["compliance"] == pytest.approx(float(mj["compliance"]), rel=1e-9)
        assert mt["cg_iters"] == int(mj["cg_iters"])
        np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), rtol=0,
                                   atol=1e-9)
    assert (st.lambda_min, st.lambda_max) == pytest.approx(
        (float(sj.lambda_min), float(sj.lambda_max)), rel=1e-9)


def test_continuation_from_jax_state_f32():
    """Default fp32 mode: each step from the JAX trajectory's state gives
    the same compliance, equilibrium and CG count. The bisection's
    noise-limited lambda (see module doc) lands within 2e-4 of JAX's
    (measured up to 1.6e-4 over these 5 steps), and the new design x
    within 2e-3 (measured up to 1.5e-3): the drift the 2-D trajectory
    test allows for."""
    tj, tt, sj = _both_problems(MBB, (24, 8), 1, f64=False)
    step = jax.jit(lambda s: jtopopt.oc_step(tj, s))
    for k in range(5):
        st, mt = ttopopt.oc_step(tt, _carry(sj))
        sj, mj = step(sj)
        assert mt["compliance"] == pytest.approx(float(mj["compliance"]), rel=1e-5)
        assert mt["cg_iters"] == int(mj["cg_iters"])
        u_ref = np.asarray(sj.u)
        assert np.abs(st.u.numpy() - u_ref).max() < 1e-5 * np.abs(u_ref).max()
        assert mt["lambda"] == pytest.approx(float(mj["lambda"]), rel=2e-4)
        assert np.abs(st.x.numpy() - np.asarray(sj.x)).max() < 2e-3


def test_cli_cpu_smoke(tmp_path, capsys):
    out = tmp_path / "out"
    train_voxelfem.main([
        "--device", "cpu", "--prob", MBB, "--grid", "[24,8]", "--mgl", "1",
        "--iter", "4", "--out", str(out), "--jid", "smoke"])
    err = capsys.readouterr().err
    lines = [l for l in err.splitlines() if l.startswith("Total Steps:")]
    assert len(lines) == 4 and lines[0].startswith("Total Steps: 0, Runtime: ")
    assert 'Compliance loss of binary densities for "192": ' in err
    assert "Final step, Compliance loss " in err
    assert "Binary Compliance loss " in err
    for f in ("smoke.vtr", "smoke_densities.npy", "smoke_history.json",
              "smoke_iter0.vtr", "smoke_iter3_densities.npy"):
        assert (out / f).exists(), f
    hist = json.loads((out / "smoke_history.json").read_text())
    assert len(hist["history"]) == len(hist["step_seconds"]) == 4
    assert all(np.isfinite(hist["history"]))
    assert np.load(out / "smoke_densities.npy").shape == (24, 8)


def test_cli_refuses_what_is_not_ported(tmp_path):
    base = ["--prob", MBB, "--grid", "[24,8]", "--iter", "1", "--out",
            str(tmp_path)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_voxelfem.main(base)          # --device defaults to cuda
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train_voxelfem.main(base + ["--device", "cpu", "--shards", "2"])
    # L-BFGS, float64, the GS smoother, the lagged preconditioner and the
    # chunked loop are ported
    result = train_voxelfem.main(base + ["--device", "cpu", "--optim", "LBFGS", "--x64"])
    assert len(result.history) == 2 and np.isfinite(result.history).all()
    result = train_voxelfem.main(base + ["--device", "cpu", "--mgl", "1",
                                         "--smoother", "gs"])
    assert np.isfinite(result.history).all()
    result = train_voxelfem.main(base[:5] + ["4"] + base[6:] + [
        "--device", "cpu", "--mgl", "1", "--precond-lag", "2", "--scan", "4"])
    assert len(result.history) == 4 and np.isfinite(result.history).all()
    assert result.solver_stats["hierarchy_builds"] == 2
