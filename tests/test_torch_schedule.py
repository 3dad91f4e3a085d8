"""The drivers' step schedule (``training.schedule``) and the counters of
the unbatched PCG loop (``solvers.conjugate_gradient``), on the CPU.

The table test drives ``Schedule.run`` with a stand-in step that records
what the schedule asked of it: which steps build the preconditioner,
whether a build replays from a graph, which state it builds into, and how
the steps group into boundaries. The counter tests run the block-Jacobi
path (classic ``mgl=0``) and the sharded solver on a one-rank mesh, whose
passes count themselves since they share the one loop.
"""

import weakref

import numpy as np
import pytest
import torch

from ndr_tpu_torch.fem import topopt
from ndr_tpu_torch.fem.simulator import problem_from_config
from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.parallel import mesh as pm
from ndr_tpu_torch.training import schedule
from ndr_tpu_torch.training.classic import ground_truth_topopt
from ndr_tpu_torch.utils import timers

BRIDGE = "problems/3d/bridge.json"

# (lag, scan_chunk, steps, forced after these steps) -> (chunk length,
# the steps that build with a graph (chunks), the steps that build without
# one (host loop), the boundaries as (first step, steps))
HOST = [(i, 1) for i in range(7)]
CASES = {
    "host-lag0": ((0, 0, 7, ()), (0, [], [], HOST)),
    "host-lag2": ((2, 0, 7, ()), (0, [], [0, 2, 4, 6], HOST)),
    "host-lag3": ((3, 0, 7, ()), (0, [], [0, 3, 6], HOST)),
    # a CG jump after step 1 makes step 2 build; the clock runs from there
    "host-lag3-forced": ((3, 0, 7, (1,)), (0, [], [0, 2, 5], HOST)),
    "host-lag0-forced": ((0, 0, 7, (1,)), (0, [], [], HOST)),
    "scan1-lag2": ((2, 1, 7, ()), (0, [], [0, 2, 4, 6], HOST)),
    "scan4-lag0": ((0, 4, 10, ()), (4, list(range(8)), [],
                                    [(0, 4), (4, 4), (8, 1), (9, 1)])),
    "scan5-lag0": ((0, 5, 12, ()), (5, list(range(10)), [],
                                    [(0, 5), (5, 5), (10, 1), (11, 1)])),
    "scan4-lag2": ((2, 4, 10, ()), (4, [0, 2, 4, 6], [8],
                                    [(0, 4), (4, 4), (8, 1), (9, 1)])),
    # rounded down to a multiple of the lag
    "scan5-lag2": ((2, 5, 10, ()), (4, [0, 2, 4, 6], [8],
                                    [(0, 4), (4, 4), (8, 1), (9, 1)])),
    "scan4-lag3": ((3, 4, 10, ()), (3, [0, 3, 6], [9],
                                    [(0, 3), (3, 3), (6, 3), (9, 1)])),
    "scan5-lag3": ((3, 5, 8, ()), (3, [0, 3], [6],
                                   [(0, 3), (3, 3), (6, 1), (7, 1)])),
    # forced inside a chunk: nothing changes
    "scan4-lag2-forced": ((2, 4, 10, (1, 5)), (4, [0, 2, 4, 6], [8],
                                               [(0, 4), (4, 4), (8, 1), (9, 1)])),
    # fewer steps than a chunk: the host loop alone
    "scan4-lag2-short": ((2, 4, 3, ()), (4, [], [0, 2], HOST[:3])),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_schedule_table(case):
    (lag, scan_chunk, steps, forced), (chunk, graph_builds, host_builds,
                                       windows) = CASES[case]
    sched = schedule.Schedule(lag=lag, scan_chunk=scan_chunk)
    assert sched.chunk == chunk == schedule.chunk_length(scan_chunk, lag)
    builds, into, seen, at_cap, done = [], {}, [], [3], [0]

    def step(precond, rebuild, use_graph):
        i = done[0]
        if rebuild:
            builds.append((i, use_graph))
            into[i] = precond
            precond = ("built at", i)
        if i in at_cap:
            timers.count("cg_passes_at_cap")
        if i in forced:
            sched.force_rebuild()
        done[0] += 1
        return {"cg_iters": 10 + i}, precond

    def boundary(i, window, dt):
        assert done[0] == i + len(window) and dt >= 0
        seen.append((i, len(window)))

    sched.run(steps, step, boundary, use_graph=True)
    assert done[0] == steps
    assert [i for i, g in builds if g] == graph_builds
    assert [i for i, g in builds if not g] == host_builds
    assert seen == windows
    # a chunk rebuilds into the chunks' one state; the host loop starts anew
    # and then builds into its own
    builds_in_order = [i for i, _ in builds]
    for k, i in enumerate(builds_in_order):
        first_host = i == (host_builds or [None])[0]
        expect = None if k == 0 or first_host else ("built at", builds_in_order[k - 1])
        assert into[i] == expect, i
    assert sched.cg_iters == [10 + i for i in range(steps)]
    assert sched.cg_passes_at_cap == [int(i in at_cap) for i in range(steps)]
    assert len(sched.step_seconds) == steps


def test_classic_frees_each_state_after_its_step(monkeypatch):
    """The driver, not the schedule, holds the OC state, so the first
    state's displacement is freed once step 0 has made the next (held
    longer, it adds one float64 u to the run's peak memory)."""
    first = []

    def recording(*args, **kwargs):
        state = oc_init(*args, **kwargs)
        first.append(weakref.ref(state.u))
        return state

    oc_init = topopt.oc_init
    monkeypatch.setattr(topopt, "oc_init", recording)
    alive = []
    ground_truth_topopt(load_problem(BRIDGE), dims=(8, 4, 4), max_iter=3,
                        multigrid_levels=1, device="cpu", log=lambda s: None,
                        callback=lambda i, s: alive.append(first[0]() is not None))
    assert alive == [False] * 3


def test_block_jacobi_classic_counts_its_cg():
    """Classic ``mgl=0`` (block-Jacobi CG): the counters see every pass."""
    res = ground_truth_topopt(load_problem(BRIDGE), dims=(8, 4, 4), max_iter=3,
                              multigrid_levels=0, dtype=torch.float64, device="cpu",
                              log=lambda s: None)
    st = res.solver_stats
    assert st["cg_iters"] == sum(res.cg_iters) > 0
    assert st["cg_passes_at_cap"] == sum(res.cg_passes_at_cap) == 0


@pytest.mark.parametrize("max_iter", [1, 500], ids=["at_cap", "converged"])
@pytest.mark.parametrize("path", ["block_jacobi", "sharded_one_rank"])
def test_unbatched_cg_counts_its_passes(path, max_iter):
    """One solve's ``cg_iters`` are the iterations it returns; a pass
    stopped at its cap adds 1 to ``cg_passes_at_cap``; each stop test is
    a counted host read."""
    prob, grid = problem_from_config(load_problem(BRIDGE), dims=(8, 4, 4),
                                     dtype=torch.float64, device="cpu")
    rho = torch.tensor(np.random.default_rng(1).uniform(0.1, 1.0, grid.dims))
    if path == "block_jacobi":
        def solve():
            return topopt.solve_displacement_cg(prob, rho, tol=1e-11, max_iter=max_iter)
        other_reads = 0
    else:
        sharded = pm.make_sharded_solver(prob, 1, 1, tol=1e-11, max_iter=max_iter,
                                         use_kernels=True)

        def solve():
            return sharded(rho)
        # one lambda_max estimate per level, the coarsest K's pinned rows
        other_reads = 3
    before = dict(timers.counters)
    _, iters = solve()
    st = timers.delta(before)
    assert st["cg_iters"] == iters and 0 < iters <= max_iter
    assert st["cg_passes_at_cap"] == int(max_iter == 1) == int(iters == max_iter)
    # the stop test reads once per iteration and once more unless capped
    assert st["host_reads"] == iters + int(iters < max_iter) + other_reads
