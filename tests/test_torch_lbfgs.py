"""The augmented-Lagrangian projected L-BFGS optimizer: ndr_tpu_torch vs
the JAX package.

2-D MBB 24x8 in float64 through ``ground_truth_topopt(optimizer="LBFGS")``
of both packages (mgl=1 Chebyshev MGPCG, smoothing + projection filters):
12 inner iterations, then the feasibility restoration. Every branch of the
optimizer (the descent test, Armijo's accept, the curvature test, the
multiplier update) is taken on host scalars, so the trajectories agree to
rounding: history and final design within 1e-8.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ndr_tpu.io.problem import load_problem
from ndr_tpu.training.classic import ground_truth_topopt as j_gt
from ndr_tpu_torch.io.problem import load_problem as t_load_problem
from ndr_tpu_torch.ops import filters as tflt
from ndr_tpu_torch.ops import lbfgs as tlbfgs
from ndr_tpu_torch.training import train_voxelfem
from ndr_tpu_torch.training.classic import ground_truth_topopt as t_gt

MBB = "problems/2d/mbb_beam.json"
_quiet = lambda s: None


def test_lbfgs_matches_jax():
    kw = dict(dims=(24, 8), max_iter=12, multigrid_levels=1, optimizer="LBFGS",
              log=_quiet)
    rj = j_gt(load_problem(MBB), dtype=jnp.float64, **kw)
    rt = t_gt(t_load_problem(MBB), dtype=torch.float64, device="cpu", **kw)
    hj, ht = np.asarray(rj.history), np.asarray(rt.history)
    assert ht.shape == hj.shape == (13,)          # 12 inner iterations + the final
    np.testing.assert_allclose(ht, hj, rtol=1e-8, atol=0)
    np.testing.assert_allclose(rt.densities, np.asarray(rj.densities), rtol=0, atol=1e-8)
    assert rt.compliance == pytest.approx(rj.compliance, rel=1e-8)
    assert rt.binary_compliance == pytest.approx(rj.binary_compliance, rel=1e-8)
    assert len(rt.step_seconds) == 12 and rt.evaluations > 13


@pytest.mark.parametrize("shift", [0.3, -0.2])
def test_project_feasible_meets_the_filtered_volume(shift):
    """The restoration moves an infeasible design down onto the filtered
    volume (to the bisection's resolution) and leaves a feasible one."""
    rng = np.random.default_rng(3)
    x = torch.tensor(np.clip(rng.uniform(0.0, 1.0, (24, 8)) * 0.6 + shift, 0, 1))
    chain = [tflt.SmoothingFilter(1), tflt.ProjectionFilter(1.0)]
    phys = lambda v: tflt.apply_filter_chain(v, chain)
    y = tlbfgs.project_feasible(x, 0.5, phys)
    if float(phys(x).mean()) > 0.5:
        assert float(phys(y).mean()) == pytest.approx(0.5, abs=1e-12)
        assert bool((y <= x + 1e-15).all())
    else:
        assert torch.equal(y, x)


def test_cli_runs_lbfgs(tmp_path):
    result = train_voxelfem.main(["--prob", MBB, "--grid", "[24,8]", "--mgl", "1",
                                  "--iter", "6", "--optim", "LBFGS", "--device", "cpu",
                                  "--out", str(tmp_path), "--jid", "lb"])
    assert len(result.history) == 7 and np.isfinite(result.history).all()
    assert result.history[-1] < result.history[0]
    assert (tmp_path / "lb_history.json").exists()


def test_lbfgs_callbacks_once_per_inner_iteration(tmp_path):
    """``callback`` and ``snapshot_cb`` of ``ground_truth_topopt`` run after
    each L-BFGS inner iteration, as after each OC step, with the design that
    iteration ended on; the CLI writes its snapshots from them."""
    seen, snaps = [], []
    rt = t_gt(t_load_problem(MBB), dims=(24, 8), max_iter=5, multigrid_levels=1,
              optimizer="LBFGS", dtype=torch.float64, device="cpu", log=_quiet,
              callback=lambda i, s: seen.append((i, s.x.clone())),
              snapshot_cb=lambda i, s, phys: snaps.append((i, float(phys().mean()))))
    assert [i for i, _ in seen] == [i for i, _ in snaps] == list(range(5))
    assert len(rt.history) == 6 and len(rt.step_seconds) == 5
    assert all(x.shape == (24, 8) and 0.0 <= float(x.min()) <= float(x.max()) <= 1.0
               for _, x in seen)
    assert not torch.equal(seen[0][1], seen[-1][1])
    train_voxelfem.main(["--prob", MBB, "--grid", "[24,8]", "--mgl", "1", "--iter", "10",
                         "--optim", "LBFGS", "--device", "cpu", "--out", str(tmp_path),
                         "--jid", "snap"])
    assert (tmp_path / "snap_iter0_densities.npy").exists()


@pytest.mark.parametrize("kw,argv", [({"precond_lag": 2}, ["--precond-lag", "2"]),
                                     ({"scan_chunk": 4}, ["--scan", "4"])])
def test_lbfgs_refuses_the_oc_loop_options(kw, argv, tmp_path):
    """The lagged preconditioner and the chunked loop are the OC loop's: an
    L-BFGS run refuses them rather than run without them."""
    with pytest.raises(ValueError, match="LBFGS"):
        t_gt(t_load_problem(MBB), dims=(24, 8), max_iter=2, multigrid_levels=1,
             optimizer="LBFGS", device="cpu", log=_quiet, **kw)
    with pytest.raises(SystemExit):
        train_voxelfem.main(["--prob", MBB, "--grid", "[24,8]", "--mgl", "1", "--iter", "2",
                             "--optim", "LBFGS", "--device", "cpu", "--out", str(tmp_path),
                             *argv])
