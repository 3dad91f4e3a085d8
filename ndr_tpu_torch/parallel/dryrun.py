"""A multi-rank dry run of the sharded paths (counterpart of
``__graft_entry__.dryrun_multichip``).

:func:`dryrun_multichip` starts ``n`` ranks (:func:`launch.spawn`) and runs
on each, with the JAX entry's configuration:

* one neural-TO training step at the JAX entry's dims ``(8n, 8, 8)`` of the
  cantilever: the Fourier-feature MLP (64 features, 128 x 3, sigma 1)
  replicated on every rank, its density sharded for the solve (sharded
  MGPCG over slabs, mgl=2, tol 1e-5, fp32), the compliance's closed-form
  adjoint and one Adam step;
* one classic OC step at 32x16x16, mgl=2, through
  ``ground_truth_topopt(shards=n)`` (slabs) and, for even ``n``, through
  ``shards=(n // 2, 2)`` (pencils; JAX runs pencils from n = 4, here
  n = 2 runs a 1 x 2 pencil mesh), held to the slab step at 5e-3.

    python -c "from ndr_tpu_torch.parallel.dryrun import dryrun_multichip; \
        dryrun_multichip(2, 'cpu')"
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ndr_tpu_torch.fem import kernels, topopt
from ndr_tpu_torch.fem.simulator import problem_from_config
from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.models import mlp
from ndr_tpu_torch.ops import volume as vol
from ndr_tpu_torch.parallel import launch
from ndr_tpu_torch.parallel import mesh as pmesh
from ndr_tpu_torch.training.neural import get_mgrid
from ndr_tpu_torch.utils.torch_setup import setup

PROB = "problems/3d/cantilever_flexion.json"
CLASSIC_DIMS = (32, 16, 16)


def dryrun_rank(device, n: int) -> dict:
    """The dry run's work on one rank (every rank returns the same
    numbers, and its own kernel launches)."""
    setup()
    rank0 = torch.distributed.get_rank() == 0
    kernels.reset_launches()
    cfg = load_problem(PROB)
    prob, grid = problem_from_config(cfg, dims=(8 * n, 8, 8), dtype=torch.float32,
                                     device=device)
    mcfg = mlp.MLPConfig(in_features=3, out_features=1, n_neurons=128, n_layers=3,
                         embedding_size=64, scale=1.0)
    model = mlp.homogeneous_init(
        mlp.init_mlp(mcfg, torch.Generator().manual_seed(0), device=device),
        cfg.max_volume)
    coords = get_mgrid(grid.dims, device=device)
    solve = pmesh.make_sharded_solver(prob, n, num_levels=2, tol=1e-5, max_iter=100,
                                      mixed_precision=False)
    opt = torch.optim.Adam(model.parameters(), lr=3e-4)
    rho = vol.sigmoid_with_constrained_mean(model(coords)[..., 0], cfg.max_volume)
    with torch.no_grad():
        u, iters = solve(rho.detach(), None)
    c = 2.0 * topopt.compliance_with_adjoint(rho, u, prob)
    opt.zero_grad()
    c.backward()
    grad_norm = float(torch.sqrt(sum((p.grad ** 2).sum() for p in model.parameters())))
    opt.step()
    c = float(c.detach())
    if not (np.isfinite(c) and c > 0 and np.isfinite(grad_norm)):
        raise RuntimeError(f"dryrun_multichip({n}): compliance {c}, |grad| {grad_norm}")
    out = {"compliance": c, "cg_iters": int(iters), "grad_norm": grad_norm,
           "route": solve.mesh.route}
    if rank0:
        print(f"dryrun_multichip({n}): neural step at {grid.dims} compliance={c:.6f}, "
              f"cg_iters={int(iters)}, |grad|={grad_norm:.4e} OK ({solve.mesh.route})",
              flush=True)

    from ndr_tpu_torch.training.classic import ground_truth_topopt

    runs = [("1-D", n)] + ([("2-D", (n // 2, 2))] if n % 2 == 0 else [])
    for name, shards in runs:
        res = ground_truth_topopt(cfg, dims=CLASSIC_DIMS, max_iter=1, multigrid_levels=2,
                                  tol=1e-4, shards=shards, device=device,
                                  log=lambda s: None)
        c1 = float(res.history[0])
        if not (np.isfinite(c1) and c1 > 0):
            raise RuntimeError(f"dryrun_multichip({n}): {name} classic compliance {c1}")
        out[f"classic {name}"] = c1
        if rank0:
            print(f"dryrun_multichip({n}): {name} {shards} classic OC step at "
                  f"{'x'.join(map(str, CLASSIC_DIMS))} compliance={c1:.6f} OK", flush=True)
    if "classic 2-D" in out:
        c1, c2 = out["classic 1-D"], out["classic 2-D"]
        if abs(c2 - c1) > 5e-3 * abs(c1):
            raise RuntimeError(f"dryrun_multichip({n}): 2-D {c2} against 1-D {c1}")
    out["launches"] = dict(kernels.launches)
    return out


def dryrun_multichip(n: int, device="cuda", backend: Optional[str] = None,
                     echo: bool = True) -> list:
    """Run :func:`dryrun_rank` on ``n`` new ranks on ``device`` (their
    cards, or one card shared over gloo with ``backend="gloo"``); returns
    every rank's result. Raises if a rank fails or the ranks disagree."""
    results = launch.spawn(dryrun_rank, n, device=device, backend=backend,
                           kwargs={"n": n}, echo=echo)
    keys = [k for k in results[0] if k not in ("launches", "route")]
    for r, res in enumerate(results[1:], 1):
        if any(not np.isclose(res[k], results[0][k], rtol=1e-9, atol=0) for k in keys):
            raise RuntimeError(f"dryrun_multichip({n}): rank {r} {res} differs from "
                               f"rank 0 {results[0]}")
    return results

