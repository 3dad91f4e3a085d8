"""The sharded solver of ndr_tpu_torch (``parallel/mesh.py``) against the
JAX package's single-device functions, on the CPU.

The rank-side checks (``parallel.checks.solver_checks``) run once per
decomposition on gloo ranks over a FileStore (``parallel.launch.spawn``):
2 slabs and 2x2 pencils of the bridge at 16x8x8, float64. While they run,
the parent computes the references:

  * the halo-summed and the overlapped stiffness apply against
    ``ndr_tpu.fem.operators.apply_k`` on the global grid (1e-12 of max|f|);
  * sharded restriction and prolongation against
    ``ndr_tpu.fem.multigrid.restrict`` / ``prolongate`` (1e-13);
  * the sharded MGPCG (float64) and refined solver (fp32 MGPCG, float64
    refinement) at tol 1e-10 against the port's dense oracle (1e-8) and
    against JAX's MGPCG at tol 1e-10 (1e-8); the refined solve's
    references take the fp32 problem's density and force, as
    ``tests/test_parallel.py``'s oracle does;
  * the sharded block-Jacobi CG at tol 1e-10 on the density 0.5 + rho / 2
    against the dense oracle (1e-8).

Besides: the shard/unshard round trips (exact), the one-rank mesh without a
process group, and the launcher's refusals.
"""

import concurrent.futures
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.fem import multigrid as jmg
from ndr_tpu.fem import operators as jops
from ndr_tpu.fem.simulator import problem_from_config as j_problem_from_config
from ndr_tpu.io.problem import load_problem as j_load_problem
from ndr_tpu_torch.fem import solvers
from ndr_tpu_torch.fem.simulator import problem_from_config
from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.parallel import checks, launch
from ndr_tpu_torch.parallel import mesh as pm

BRIDGE = "problems/3d/bridge.json"
DIMS = (16, 8, 8)
TOL = 1e-10
SHAPES = [(2,), (2, 2)]


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module")
def sharded():
    """{shape: every rank's solver_checks result} and the references."""
    with concurrent.futures.ThreadPoolExecutor(len(SHAPES)) as pool:
        futures = {shape: pool.submit(
            launch.spawn, checks.solver_checks, int(np.prod(shape)), device="cpu",
            threads=1, kwargs=dict(shape=shape, prob_path=BRIDGE, dims=DIMS,
                                   num_levels=1, tol=TOL))
            for shape in SHAPES}
        # the references, while the ranks run (the same seeded draws)
        rng = np.random.default_rng(0)
        pj, grid = j_problem_from_config(j_load_problem(BRIDGE), dims=DIMS,
                                         dtype=jnp.float64)
        u = rng.standard_normal(grid.nodes_per_dim + (3,))
        rho = rng.uniform(0.05, 1.0, grid.dims)
        r = rng.standard_normal(grid.nodes_per_dim + (3,))
        uc = rng.standard_normal(grid.coarsened().nodes_per_dim + (3,))
        ref = {"r": r, "u": u}
        ref["f"] = np.asarray(jops.apply_k(jnp.asarray(u), pj.young(jnp.asarray(rho)),
                                           pj.K0, grid))
        ref["restrict"] = np.asarray(jmg.restrict(jnp.asarray(r), 3))
        ref["prolong"] = np.asarray(jmg.prolongate(jnp.asarray(uc), 3))
        solve = jmg.make_mg_solver(pj, jmg.MGSolverSettings(
            num_levels=1, tol=TOL, smoother="chebyshev", cg_iter=300))
        ref["jax_f64"] = np.asarray(solve(jnp.asarray(rho), None)[0])
        # the refined solve's density and force are the fp32 problem's
        rho32 = rho.astype(np.float32).astype(np.float64)
        f32 = dataclasses.replace(pj, force=pj.force.astype(jnp.float32).astype(jnp.float64))
        ref["jax_refined"] = np.asarray(solve(jnp.asarray(rho32), None, prob=f32)[0])
        cfg = load_problem(BRIDGE)
        for name, dtype, x in (("oracle_f64", torch.float64, rho),
                               ("oracle_refined", torch.float32, rho32),
                               ("oracle_jacobi", torch.float64, 0.5 + 0.5 * rho)):
            pt, g = problem_from_config(cfg, dims=DIMS, dtype=dtype, device="cpu")
            ref[name] = solvers.dense_solve(pt.young(torch.tensor(x)), pt.K0,
                                            pt.dirichlet_mask, pt.force.double(), g).numpy()
        return {shape: f.result() for shape, f in futures.items()}, ref


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("what", ["halo_sum", "overlap"])
def test_sharded_apply_matches_jax(sharded, shape, what):
    results, ref = sharded
    for res in results[shape]:   # every rank gathers the same global field
        assert _rel(res[what], ref["f"]) < 1e-12


@pytest.mark.parametrize("shape", SHAPES)
def test_psum_vdot_and_sync(sharded, shape):
    results, ref = sharded
    want = float(np.vdot(ref["u"], ref["r"]))
    for res in results[shape]:
        assert abs(res["vdot"] - want) < 1e-12 * abs(want)
        assert res["sync_exact"]
    assert sorted(res["coords"] for res in results[shape]) == \
        [tuple(c) for c in np.ndindex(*shape)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("what", ["restrict", "prolong"])
def test_sharded_transfers_match_jax(sharded, shape, what):
    results, ref = sharded
    for res in results[shape]:
        assert _rel(res[what], ref[what]) < 1e-13


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_block_jacobi_cg_matches_oracle(sharded, shape):
    results, ref = sharded
    res = results[shape][0]
    assert 0 < res["iters_jacobi"] < 2000
    assert _rel(res["u_jacobi"], ref["oracle_jacobi"]) < 1e-8


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("solve", ["f64", "refined"])
def test_sharded_mgpcg_matches_oracle_and_jax(sharded, shape, solve):
    results, ref = sharded
    u = results[shape][0][f"u_{solve}"]
    assert u.dtype == np.float64
    assert _rel(u, ref[f"oracle_{solve}"]) < 1e-8
    assert _rel(u, ref[f"jax_{solve}"]) < 1e-8
    for res in results[shape][1:]:   # the gathered solution is replicated
        np.testing.assert_array_equal(res[f"u_{solve}"], u)
        assert res[f"iters_{solve}"] == results[shape][0][f"iters_{solve}"]
    assert "gloo" in results[shape][0]["describe"]


@pytest.mark.parametrize("shape", SHAPES)
def test_shard_unshard_round_trip(shape):
    grid = load_problem(BRIDGE).make_grid(DIMS)
    sg = pm.ShardedGrid(grid, *shape) if len(shape) == 1 else pm.ShardedGrid2D(grid, *shape)
    rng = np.random.default_rng(3)
    u = torch.tensor(rng.standard_normal(grid.nodes_per_dim + (3,)))
    e = torch.tensor(rng.standard_normal(grid.dims))
    blocks = pm.shard_node_field(u, sg)
    assert blocks.shape == shape + tuple(n + 1 for n in sg.local_dims) + (3,)
    assert torch.equal(pm.unshard_node_field(blocks, sg), u)
    eb = pm.shard_elem_field(e, sg)
    assert eb.shape == shape + sg.local_dims
    assert torch.equal(pm._assemble([eb[c] for c in np.ndindex(*shape)], shape, False), e)


def test_one_rank_mesh_without_a_group_matches_oracle():
    """make_sharded_solver on a one-rank mesh (no process group: every
    collective is the identity) is the sharded algorithm on the whole
    grid."""
    pt, grid = problem_from_config(load_problem(BRIDGE), dims=(8, 4, 4),
                                   dtype=torch.float64, device="cpu")
    rho = torch.tensor(np.random.default_rng(1).uniform(0.1, 1.0, grid.dims))
    solve = pm.make_sharded_solver(pt, 1, 1, tol=1e-11, max_iter=200, use_kernels=True)
    u, iters = solve(rho)
    assert solve.mesh.route.startswith("local") and 0 < iters < 200
    oracle = solvers.dense_solve(pt.young(rho), pt.K0, pt.dirichlet_mask, pt.force, grid)
    assert _rel(u, oracle) < 1e-8


def test_refusals(monkeypatch):
    pt, _ = problem_from_config(load_problem(BRIDGE), dims=(8, 4, 4), device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pm.make_sharded_solver(pt, 2, 1)
    with pytest.raises(ValueError, match="not divisible"):
        pm.ShardedGrid(pt.grid, 3)
    p4, _ = problem_from_config(load_problem(BRIDGE), dims=(4, 8, 8), device="cpu")
    with pytest.raises(ValueError, match="2\\^3"):
        pm.make_sharded_mgpcg(pm.ShardedGrid(p4.grid, 1), p4, 3, pm.Mesh((1,), "cpu"))
    # the kernels take degree 1: use_kernels=True on degree 2 raises, as in
    # the unsharded solver
    cfg2 = dataclasses.replace(load_problem(BRIDGE), order_fem=(2, 2, 2))
    p2, _ = problem_from_config(cfg2, dims=(4, 2, 2), device="cpu")
    with pytest.raises(ValueError, match="degree-2"):
        pm.make_sharded_solver(p2, 1, 1, use_kernels=True)
    with pytest.raises(ValueError, match="nccl"):
        launch.rank_device("cpu", 0, 1, "nccl")
    # two ranks on one card: NCCL refuses, gloo shares it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one card per rank"):
        launch.rank_device("cuda", 1, 2, "nccl")
    assert launch.rank_device("cuda", 1, 2, "gloo") == torch.device("cuda", 0)


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match=r"rank \d exited with code"):
        launch.spawn("ndr_tpu_torch.parallel.checks:solver_checks", 2, device="cpu",
                     threads=1, kwargs=dict(shape=(3,), prob_path=BRIDGE, dims=DIMS,
                                            num_levels=1, tol=TOL), timeout=60)


@pytest.mark.slow
def test_sharded_solve_matches_jax_sharded_solver(sharded, tmp_path):
    """JAX's own ``make_sharded_solver`` on 2 virtual CPU devices, in a
    subprocess as ``tests/test_parallel.py`` runs it, against the port's
    2-slab solve of the same problem (float64, mgl=1, tol 1e-10; 1e-8).
    Slow: the virtual-device compile takes minutes on the CPU."""
    body = textwrap.dedent(f"""
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 2)
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp, numpy as np
        from ndr_tpu.fem.simulator import problem_from_config
        from ndr_tpu.io.problem import load_problem
        from ndr_tpu.parallel import mesh as pmesh
        prob, grid = problem_from_config(load_problem({BRIDGE!r}), dims={DIMS!r},
                                         dtype=jnp.float64)
        rng = np.random.default_rng(0)
        rng.standard_normal(grid.nodes_per_dim + (3,))
        rho = jnp.asarray(rng.uniform(0.05, 1.0, grid.dims))
        solve = pmesh.make_sharded_solver(prob, num_shards=2, num_levels=1, tol={TOL!r},
                                          max_iter=200, mixed_precision=False)
        u, iters = solve(rho)
        np.save({str(tmp_path / "u.npy")!r}, np.asarray(u))
        """)
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2 "
               + os.environ.get("XLA_FLAGS", ""))
    proc = subprocess.run([sys.executable, "-c", body], env=env, capture_output=True,
                          text=True, timeout=1200,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    results, _ = sharded
    assert _rel(results[(2,)][0]["u_f64"], np.load(tmp_path / "u.npy")) < 1e-8


def test_cli_shards_under_torchrun(tmp_path, capsys):
    """``train_voxelfem --shards 2`` under torchrun on the CPU (gloo): rank
    0 alone logs and writes the artifacts; started without torchrun, the
    CLI says how to start it."""
    from ndr_tpu_torch.training import train_voxelfem

    argv = ["--prob", BRIDGE, "--grid", "[16,8,8]", "--mgl", "1", "--iter", "2",
            "--shards", "2", "--device", "cpu", "--out", str(tmp_path), "--jid", "s2"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "2", "-m",
                           "ndr_tpu_torch.training.train_voxelfem", *argv],
                          cwd=root, capture_output=True, text=True, timeout=300,
                          env=dict(env, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stderr.count("Total Steps: 0,") == 1
    assert "sharded MGPCG over a 2 mesh of ranks (gloo)" in proc.stderr
    for f in ("s2_densities.npy", "s2.vtr", "s2_history.json"):
        assert (tmp_path / f).exists()
    with pytest.raises(SystemExit):
        train_voxelfem.main(argv)
    assert "torchrun --nproc_per_node 2" in capsys.readouterr().err
