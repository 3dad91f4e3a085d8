"""Rank-side bodies for :func:`ndr_tpu_torch.parallel.launch.spawn`: what
the parity tests and ``chip_smoke.py`` run on every rank of a sharded run.
Each returns host values (NumPy arrays, numbers), the same on every rank
where they are global; the caller compares them with single-process
references.
"""

from __future__ import annotations

import re
import time
from typing import Sequence

import numpy as np
import torch

from ndr_tpu_torch.fem import kernels
from ndr_tpu_torch.fem import multigrid as mg
from ndr_tpu_torch.fem.simulator import problem_from_config
from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.parallel import mesh as pm
from ndr_tpu_torch.utils.torch_setup import setup

_CG_RE = re.compile(r"cg_iters (\d+)")


def _decomposition(grid, shape):
    if len(shape) == 1:
        return pm.ShardedGrid(grid, shape[0])
    return pm.ShardedGrid2D(grid, *shape)


def _solver(prob, shape, **kw):
    if len(shape) == 1:
        return pm.make_sharded_solver(prob, shape[0], **kw)
    return pm.make_sharded_solver_2d(prob, *shape, **kw)


def _host(t):
    return t.detach().cpu().numpy()


def solver_checks(device, shape: Sequence[int], prob_path: str, dims, num_levels: int,
                  tol: float, seed: int = 0) -> dict:
    """The sharded building blocks on a ``shape`` mesh in float64, each
    result gathered to its global field: the halo-summed and the
    overlapped stiffness apply of a random u on a random density, the dot
    product, owner-consistent planes after a sync, restriction and
    prolongation of random fields, and the sharded block-Jacobi CG (on
    the density 0.5 + rho / 2), MGPCG (float64) and refined (fp32 +
    float64 refinement) solves at ``tol``, kernels on."""
    setup()
    shape = tuple(shape)
    cfg = load_problem(prob_path)
    prob, grid = problem_from_config(cfg, dims=tuple(dims), dtype=torch.float64,
                                     device=device)
    sg = _decomposition(grid, shape)
    mesh = pm.Mesh(shape, device)
    c, lg, N = mesh.coords, sg.local_grid, grid.ndim
    rng = np.random.default_rng(seed)
    u = torch.tensor(rng.standard_normal(grid.nodes_per_dim + (N,)), device=device)
    rho = torch.tensor(rng.uniform(0.05, 1.0, grid.dims), device=device)
    r = torch.tensor(rng.standard_normal(grid.nodes_per_dim + (N,)), device=device)
    coarse = grid.coarsened()
    uc = torch.tensor(rng.standard_normal(coarse.nodes_per_dim + (N,)), device=device)
    young = prob.young(rho)
    u_l, young_l = pm.node_block(u, sg, c), pm.elem_block(young, sg, c)

    def gather(x):
        return _host(pm.gather_field(mesh, x, overlap=True))

    out = {"coords": c, "route": mesh.route}
    for name, overlap in (("halo_sum", False), ("overlap", True)):
        apply = pm.make_sharded_apply_k(sg, prob.K0, mesh, overlap=overlap)
        out[name] = gather(apply(u_l, young_l))
    out["vdot"] = float(pm.psum_vdot(u_l, pm.node_block(r, sg, c), mesh))
    bumped = u_l.clone()
    for ax, ci in enumerate(c):
        if ci > 0:
            bumped.select(ax, 0).add_(1.0)
    out["sync_exact"] = bool(torch.equal(pm.sync_halo_displacements(bumped, mesh), u_l))
    out["restrict"] = gather(pm.restrict_sharded(pm.node_block(r, sg, c), N, mesh))
    out["prolong"] = gather(pm.prolong_sharded(
        pm.node_block(uc, _decomposition(coarse, shape), c), N))
    b_l = pm.node_block(prob.force.masked_fill(prob.dirichlet_mask, 0.0), sg, c)
    mask_l = pm.node_block(prob.dirichlet_mask, sg, c)
    # block Jacobi on a stiffer density, 0.5 + rho / 2 (moduli within 8x)
    young_j = pm.elem_block(prob.young(0.5 + 0.5 * rho), sg, c)
    x, out["iters_jacobi"] = pm.make_sharded_cg(sg, prob, mesh, tol, 2000)(
        torch.zeros_like(b_l), young_j, b_l, mask_l)
    out["u_jacobi"] = gather(x)
    solve = _solver(prob, shape, num_levels=num_levels, tol=tol, max_iter=200,
                    mixed_precision=False, use_kernels=True)
    x, out["iters_f64"] = solve(rho)
    out["u_f64"] = _host(x)
    prob32, _ = problem_from_config(cfg, dims=tuple(dims), dtype=torch.float32,
                                    device=device)
    solve32 = _solver(prob32, shape, num_levels=num_levels, tol=tol, max_iter=200,
                      mixed_precision=True, use_kernels=True)
    x, out["iters_refined"] = solve32(rho.float())
    out["u_refined"] = _host(x)
    out["describe"] = solve32.description
    return out


def sharded_classic(device, shards, prob_path: str, dims, num_levels: int, iters: int,
                    tol: float = 1e-4, dtype: str = "float32",
                    use_kernels="auto") -> dict:
    """``ground_truth_topopt(shards=...)`` on this rank: the OC history,
    each step's seconds and CG iterations, this rank's kernel launches
    over the run, and the halo traffic of one level-0 apply of the
    sharded solver (exchanges and bytes this rank sent; the fp32 CG
    apply and the float64 residual apply)."""
    from ndr_tpu_torch.training.classic import ground_truth_topopt

    setup()
    cfg = load_problem(prob_path)
    lines = []
    kernels.reset_launches()
    res = ground_truth_topopt(cfg, dims=tuple(dims), max_iter=iters,
                              multigrid_levels=num_levels, tol=tol, shards=shards,
                              dtype=getattr(torch, dtype), device=device,
                              use_kernels=use_kernels, log=lines.append)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = dict(kernels.launches)
    out = {"history": res.history, "step_seconds": res.step_seconds,
           "compliance": res.compliance,
           "cg_iters": [int(m) for m in _CG_RE.findall("".join(lines))],
           "launches": launches, "log": "".join(lines)}
    # one level-0 apply of each type through a solver built as the driver
    # builds it, on the final design
    prob, _ = problem_from_config(cfg, dims=tuple(dims), dtype=getattr(torch, dtype),
                                  device=device)
    shape = tuple(shards) if isinstance(shards, (tuple, list)) else (shards,)
    solve = _solver(prob, shape, num_levels=num_levels, tol=tol, use_kernels=use_kernels)
    mesh, sg = solve.mesh, solve.sharded_grid
    out["route"], out["local_dims"] = mesh.route, sg.local_grid.dims
    rho_l = pm.elem_block(torch.as_tensor(res.physical, device=device), sg, mesh.coords)
    u_l = pm.node_block(torch.ones_like(prob.force), sg, mesh.coords)
    halo = {}
    for name, dt in (("fp32 apply", torch.float32), ("float64 residual", torch.float64)):
        apply = solve.shard_solve.level0_apply(prob.young(rho_l.to(dt)))
        mesh.reset_stats()
        apply(u_l.to(dt))
        halo[name] = {"exchanges": mesh.stats["exchanges"],
                      "bytes": mesh.stats["halo_bytes"]}
    out["halo_per_apply"] = halo
    return out


def world_one_check(device, prob_path: str, dims, num_levels: int, tol: float,
                    seed: int = 0) -> dict:
    """``make_sharded_solver`` on a one-rank mesh of this group (NCCL on the
    card) against the unsharded MGPCG, both refined to ``tol``: the
    relative max difference of the two solutions, their CG iterations and
    seconds."""
    setup()
    cfg = load_problem(prob_path)
    prob, grid = problem_from_config(cfg, dims=tuple(dims), dtype=torch.float32,
                                     device=device)
    rho = torch.tensor(np.random.default_rng(seed).uniform(0.05, 1.0, grid.dims),
                       dtype=torch.float32, device=device)
    sharded = pm.make_sharded_solver(prob, 1, num_levels, tol=tol)
    plain = mg.make_mg_solver(prob, mg.MGSolverSettings(
        num_levels=num_levels, tol=tol, smoother="chebyshev", cheb_degree=2))
    out = {"route": sharded.mesh.route}
    for name, solve in (("sharded", sharded), ("unsharded", plain)):
        t0 = time.perf_counter()
        u, it = solve(rho, None)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out[name] = (u, int(it), time.perf_counter() - t0)
    a, b = out["sharded"][0], out["unsharded"][0]
    out["rel_diff"] = float((a - b).abs().max() / b.abs().max())
    for name in ("sharded", "unsharded"):
        out[name] = out[name][1:]
    return out
