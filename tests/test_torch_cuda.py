"""The CUDA stiffness kernels vs their plain twins, on the card.

Needs an NVIDIA card with ``nvcc`` (an sm_90a build); each test skips
where ``torch.cuda.is_available()`` is False. This file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from ndr_tpu_torch.fem import kernels
from ndr_tpu_torch.fem import multigrid as mg
from ndr_tpu_torch.fem.simulator import problem_from_config
from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.models import mlp
from ndr_tpu_torch.training import neural, train_xdg
from ndr_tpu_torch.training.classic import ground_truth_topopt
from ndr_tpu_torch.utils import profile_neural, profile_oc
from ndr_tpu_torch.utils.torch_setup import setup

pytestmark = pytest.mark.gpu

CASES = [
    ("problems/2d/mbb_beam.json", (12, 6)),
    ("problems/3d/cantilever_flexion.json", (8, 4, 4)),
    ("problems/3d/cantilever_flexion.json", (6, 4, 2)),
    ("problems/3d/cantilever_flexion.json", (32, 16, 16)),
    ("problems/3d/bridge.json", (13, 7, 5)),
    ("problems/3d/bridge.json", (64, 32, 16)),
    # dims that are no multiple of the element-centric fp32 kernel's slab
    # or tiles, more than one tile along y and z, a one-element-thick 3-D
    # grid, an odd 2-D grid
    ("problems/3d/bridge.json", (37, 19, 23)),
    ("problems/3d/bridge.json", (20, 18, 34)),
    ("problems/3d/bridge.json", (9, 5, 1)),
    ("problems/2d/mbb_beam.json", (37, 21)),
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    setup()
    return torch.device("cuda")


def _rel(out, ref) -> float:
    return float((out.double() - ref.double()).abs().max() / ref.double().abs().max())


@pytest.mark.parametrize("prob_path,dims", CASES)
def test_fine_kernels_match_twins(device, prob_path, dims):
    prob, grid = problem_from_config(load_problem(prob_path), dims=dims,
                                     device=device)
    rng = np.random.default_rng(0)
    rho = torch.tensor(rng.uniform(1e-3, 1.0, grid.dims), device=device)
    u = torch.tensor(1e3 * rng.standard_normal(grid.nodes_per_dim + (grid.ndim,)),
                     device=device)
    young = prob.young(rho)
    kernels.reset_launches()
    args32 = (u.float(), young.float(), prob.K0.float())
    ref32 = kernels.apply_k_fine_plain(*args32, grid)
    ref64 = kernels.apply_k_fine_plain(u, young, prob.K0, grid)
    # node-centric and element-centric kernels; fp32: the summation order
    # differs; f64: rounding only
    for f32_kernel, f64_kernel in ((kernels.apply_k_fine_f32, kernels.apply_k_fine_f64),
                                   (kernels.apply_k_fine_elem_f32,
                                    kernels.apply_k_fine_elem_f64)):
        f32 = f32_kernel(*args32, grid)
        f64 = f64_kernel(u, young, prob.K0, grid)
        torch.cuda.synchronize()
        assert _rel(f32, ref32) < 1e-5
        assert _rel(f64, ref64) < 1e-12
    assert kernels.launches == {"apply_k_fine_f32": 1, "apply_k_fine_elem_f32": 1,
                                "apply_k_cached_f32": 0, "cached_stencil": 0,
                                "apply_k_fine_f64": 1, "apply_k_fine_elem_f64": 1,
                                "apply_k_cached_bf16": 0, "cached_stencil_bf16": 0,
                                "apply_k_cached_f64": 0, "cached_stencil_f64": 0}


@pytest.mark.parametrize("prob_path,dims", CASES)
def test_cached_kernel_matches_twin(device, prob_path, dims):
    """Stencil assembly and cached apply on a random stack on the grid
    itself (any shape) and on the Galerkin level-1 and level-2 stacks where
    the grid coarsens. The assembly sums each slot in its twin's order, so
    the two are bitwise equal."""
    prob, grid = problem_from_config(load_problem(prob_path), dims=dims,
                                     dtype=torch.float32, device=device)
    rng = np.random.default_rng(3)
    d = grid.nodes_per_elem * grid.ndim
    stacks = [(grid, torch.tensor(rng.standard_normal(grid.dims + (d, d)),
                                  dtype=torch.float32, device=device))]
    levels = min(2, mg.max_feasible_coarsenings(grid))
    if levels:
        cfg = mg.build_mg_config(prob, levels)
        young = prob.young(torch.tensor(rng.uniform(0.1, 1.0, grid.dims),
                                        dtype=torch.float32, device=device))
        Ke = mg.build_level_ke(cfg, young, 1)
        stacks.append((cfg.levels[1].grid, Ke))
        if levels == 2:
            stacks.append((cfg.levels[2].grid, mg.coarsen_ke(Ke, grid.ndim).contiguous()))
    kernels.reset_launches()
    for g, Ke in stacks:
        stencil = kernels.cached_stencil(Ke, g)
        u = torch.tensor(rng.standard_normal(g.nodes_per_dim + (g.ndim,)),
                         dtype=torch.float32, device=device)
        f = kernels.apply_k_cached_f32(u, stencil, g)
        torch.cuda.synchronize()
        torch.testing.assert_close(stencil, kernels.cached_stencil_plain(Ke, g),
                                   rtol=0, atol=0)
        assert _rel(f, kernels.apply_k_cached_f32_plain(u, stencil, g)) < 1e-5
    assert kernels.launches["cached_stencil"] == len(stacks)
    assert kernels.launches["apply_k_cached_f32"] == len(stacks)


@pytest.mark.parametrize("prob_path,dims", CASES)
def test_bf16_cached_kernels_match_twins(device, prob_path, dims):
    """The bf16 stencil assembly (fp32 sums in the twin's order, each slot
    rounded once to nearest even: bitwise equal to the twin) and the bf16
    apply (slots widened to fp32: the summation order differs)."""
    prob, grid = problem_from_config(load_problem(prob_path), dims=dims,
                                     dtype=torch.float32, device=device)
    rng = np.random.default_rng(12)
    d = grid.nodes_per_elem * grid.ndim
    stacks = [(grid, torch.tensor(rng.standard_normal(grid.dims + (d, d)),
                                  dtype=torch.float32, device=device))]
    if mg.max_feasible_coarsenings(grid):
        cfg = mg.build_mg_config(prob, 1)
        young = prob.young(torch.tensor(rng.uniform(0.1, 1.0, grid.dims),
                                        dtype=torch.float32, device=device))
        stacks.append((cfg.levels[1].grid, mg.build_level_ke(cfg, young, 1)))
    kernels.reset_launches()
    for g, Ke in stacks:
        S = kernels.cached_stencil_bf16(Ke, g)
        u = torch.tensor(rng.standard_normal(g.nodes_per_dim + (g.ndim,)),
                         dtype=torch.float32, device=device)
        f = kernels.apply_k_cached_bf16(u, S, g)
        torch.cuda.synchronize()
        assert S.dtype == torch.bfloat16
        torch.testing.assert_close(S, kernels.cached_stencil_bf16_plain(Ke, g),
                                   rtol=0, atol=0)
        assert _rel(f, kernels.apply_k_cached_bf16_plain(u, S, g)) < 1e-5
    assert kernels.launches["cached_stencil_bf16"] == len(stacks)
    assert kernels.launches["apply_k_cached_bf16"] == len(stacks)
    assert kernels.launches["cached_stencil"] == kernels.launches["apply_k_cached_f32"] == 0


@pytest.mark.parametrize("prob_path,dims", CASES)
def test_f64_cached_kernels_match_twins(device, prob_path, dims):
    """The float64 stencil assembly (float64 sums in the twin's order:
    bitwise equal) and the float64 apply (within 1e-12 of max|f|: the
    summation order differs) on a random stack on the grid and on the
    float64 Galerkin level-1 and level-2 stacks."""
    prob, grid = problem_from_config(load_problem(prob_path), dims=dims,
                                     dtype=torch.float64, device=device)
    rng = np.random.default_rng(14)
    d = grid.nodes_per_elem * grid.ndim
    stacks = [(grid, torch.tensor(rng.standard_normal(grid.dims + (d, d)), device=device))]
    levels = min(2, mg.max_feasible_coarsenings(grid))
    if levels:
        cfg = mg.build_mg_config(prob, levels)
        young = prob.young(torch.tensor(rng.uniform(0.1, 1.0, grid.dims), device=device))
        Ke = mg.build_level_ke(cfg, young, 1)
        stacks.append((cfg.levels[1].grid, Ke))
        if levels == 2:
            stacks.append((cfg.levels[2].grid, mg.coarsen_ke(Ke, grid.ndim).contiguous()))
    kernels.reset_launches()
    for g, Ke in stacks:
        S = kernels.cached_stencil_f64(Ke, g)
        u = torch.tensor(rng.standard_normal(g.nodes_per_dim + (g.ndim,)), device=device)
        f = kernels.apply_k_cached(u, S, g)
        torch.cuda.synchronize()
        assert S.dtype == torch.float64 and f.dtype == torch.float64
        torch.testing.assert_close(S, kernels.cached_stencil_f64_plain(Ke, g),
                                   rtol=0, atol=0)
        assert _rel(f, kernels.apply_k_cached_f64_plain(u, S, g)) < 1e-12
    assert kernels.launches["cached_stencil_f64"] == len(stacks)
    assert kernels.launches["apply_k_cached_f64"] == len(stacks)
    assert kernels.launches["cached_stencil"] == kernels.launches["apply_k_cached_f32"] == 0


def _graph_case(device, smoother, coarse_solver="auto"):
    prob, grid = problem_from_config(load_problem(CASES[3][0]), dims=CASES[3][1],
                                     dtype=torch.float32, device=device)
    settings = mg.MGSolverSettings(num_levels=2, smoother=smoother, cheb_degree=1,
                                   use_kernels=True, coarse_solver=coarse_solver)
    solve = mg.make_mg_solver(prob, settings)
    rng = np.random.default_rng(13)
    rho0, rho1 = (torch.tensor(rng.uniform(0.05, 1.0, grid.dims), dtype=torch.float32,
                               device=device) for _ in range(2))
    r = torch.tensor(rng.standard_normal(grid.nodes_per_dim + (3,)), dtype=torch.float32,
                     device=device)
    return prob, settings, solve, rho0, rho1, mg._zero_dirichlet(
        mg.build_level_states(solve.cfg, prob, prob.young(rho0))[0], r)


@pytest.mark.parametrize("smoother,coarse_solver", [
    ("chebyshev", "ns"), ("chebyshev", "cholesky"), ("gs", "ns"), ("gs", "cholesky")])
def test_precond_graph_replay_matches_eager(device, smoother, coarse_solver):
    """The preconditioner replayed from its CUDA graph equals its eager call
    (within 1e-6 of max|z|), before and after a rebuild that writes into the
    captured tensors (against an eager call on a fresh build); one capture
    serves both, and the launch counts are the replays'."""
    prob, settings, solve, rho0, rho1, r = _graph_case(device, smoother, coarse_solver)
    state = solve.build_precond(rho0, use_graph=True)
    assert state.coarse[0] == {"ns": "ns", "cholesky": "chol"}[coarse_solver]
    eager = mg._make_preconditioner(settings, state.levels, state.coarse)
    graphed = mg._make_preconditioner(settings, state.levels, state.coarse, state)
    z_ref = eager(r)
    mg.reset_stats()
    z = graphed(r)
    kernels.reset_launches()
    z2 = graphed(r)
    per_replay = dict(kernels.launches)
    torch.cuda.synchronize()
    assert mg.stats["graph_captures"] == 1 and mg.stats["graph_replays"] == 2
    assert per_replay["apply_k_fine_f32"] > 0 and per_replay["apply_k_cached_f32"] > 0
    for out in (z, z2):
        assert float((out - z_ref).abs().max()) <= 1e-6 * float(z_ref.abs().max())
    assert z.data_ptr() != z2.data_ptr()   # each call returns its own copy
    assert solve.build_precond(rho1, into=state) is state
    z_new = graphed(r)
    fresh = solve.build_precond(rho1)
    z_fresh = mg._make_preconditioner(settings, fresh.levels, fresh.coarse)(r)
    torch.cuda.synchronize()
    assert mg.stats["graph_captures"] == 1
    assert float((z_new - z_fresh).abs().max()) <= 1e-6 * float(z_fresh.abs().max())
    assert float((z_new - z_ref).abs().max()) > 1e-3 * float(z_ref.abs().max())


def test_precond_graph_capture_refuses_unuploaded_k0(device):
    """A capture whose fine kernels would need K0's blocks uploaded raises
    (the upload is host work a replay would not repeat); it does not fall
    back to the eager preconditioner."""
    prob, settings, solve, rho0, _, r = _graph_case(device, "chebyshev")
    state = solve.build_precond(rho0)
    fn = mg._make_preconditioner(settings, state.levels, state.coarse)
    kernels._fine_k0.clear()
    lv0 = dataclasses.replace(state.levels[0], fine_apply=None)  # skips its own upload
    with pytest.raises(RuntimeError, match="before CUDA-graph capture"):
        mg.PrecondGraph(fn, r, lv0, warmup=False)
    # with the upload done first the same capture succeeds
    graph = mg.PrecondGraph(fn, r, state.levels[0], warmup=False)
    assert float((graph(r) - fn(r)).abs().max()) <= 1e-6 * float(fn(r).abs().max())


@pytest.mark.parametrize("smoother", ["chebyshev", "gs"])
def test_classic_scan_on_card_matches_host_loop(device, smoother):
    """ground_truth_topopt with --precond-lag 2 --scan 4 on the card (the
    chunk replays its preconditioner from one graph) against the host loop
    with the same lag, from the design of 6 fresh steps (from the uniform
    start the first lagged solve can stall at the CG cap, which amplifies
    rounding): the same builds, histories within 1e-5."""
    cfg = load_problem(CASES[3][0])
    kw = dict(dims=CASES[3][1], multigrid_levels=2, smoother=smoother,
              device=device, log=lambda s: None)
    init = ground_truth_topopt(cfg, max_iter=6, **kw).densities
    kw.update(max_iter=4, precond_lag=2, init=init)
    host = ground_truth_topopt(cfg, **kw)
    chunked = ground_truth_topopt(cfg, scan_chunk=4, **kw)
    assert chunked.solver_stats["graph_captures"] == 1
    assert chunked.solver_stats["graph_replays"] > 0
    assert chunked.solver_stats["hierarchy_builds"] == host.solver_stats["hierarchy_builds"]
    np.testing.assert_allclose(chunked.history, host.history, rtol=1e-5)


def _check_partials_only_on_block_faces(device, prob_path, dims, dtype):
    _, grid = problem_from_config(load_problem(prob_path), dims=dims, device=device)
    slab, ty, tz, slots = kernels.elem_geometry(grid, device, dtype)
    tiles = (slab, ty, tz)[-grid.ndim:]   # elements per block along each axis
    blocks = int(np.prod([-(-n // t) for n, t in zip(dims, tiles)]))
    shell = int(np.prod([t + 1 for t in tiles]) - np.prod([t - 1 for t in tiles]))
    assert slots == blocks * shell
    if dims == (192, 96, 96):
        assert slots < grid.num_nodes


@pytest.mark.parametrize("prob_path,dims", [CASES[-1], CASES[5],
                                             ("problems/3d/bridge.json", (192, 96, 96))])
def test_elem_f32_partials_only_on_block_faces(device, prob_path, dims):
    """The element-centric fp32 kernel's scratch: one slot per node of each
    block's shell (its node box less its interior), N fp32 each; at
    192x96x96 that is less than the f field (a partial plane per slab
    plane, trailing offset and component, as the TPU kernel keeps, is
    ~4.5x it)."""
    _check_partials_only_on_block_faces(device, prob_path, dims, torch.float32)


@pytest.mark.parametrize("prob_path,dims", [CASES[-1], CASES[5],
                                             ("problems/3d/bridge.json", (192, 96, 96))])
def test_elem_f64_partials_only_on_block_faces(device, prob_path, dims):
    """The same for the float64 kernel, under its own geometry (its blocks
    hold twice the registers and shared memory of the fp32 ones)."""
    _check_partials_only_on_block_faces(device, prob_path, dims, torch.float64)


def test_kernels_refuse_f64_hierarchy(device):
    """A float64 CUDA hierarchy with kernels on (explicit or "auto") runs
    its level 0 and its cached levels through the float64 kernels and
    agrees with the plain ops (kernels off, an explicit choice of them)
    to 1e-10; what the kernels refuse is a degree-2 grid under an explicit
    ``use_kernels=True`` ("auto" takes the plain applies there)."""
    cfg = load_problem(CASES[3][0])
    prob, grid = problem_from_config(cfg, dims=(16, 8, 8), dtype=torch.float64,
                                     device=device)
    settings = mg.MGSolverSettings(num_levels=2, smoother="chebyshev", use_kernels=True)
    rho = torch.full(grid.dims, 0.5, dtype=torch.float64, device=device)
    kernels.reset_launches()
    u_on, _ = mg.make_mg_solver(prob, settings)(rho)
    torch.cuda.synchronize()
    assert kernels.launches["apply_k_fine_f64"] > 0
    assert kernels.launches["apply_k_cached_f64"] > 0
    assert kernels.launches["cached_stencil_f64"] == 1
    assert kernels.launches["apply_k_fine_f32"] == kernels.launches["apply_k_cached_f32"] == 0
    kernels.reset_launches()
    u_off, _ = mg.make_mg_solver(
        prob, dataclasses.replace(settings, use_kernels=False))(rho)
    assert kernels.launches == {name: 0 for name in kernels.launches}
    f = prob.force.reshape(-1)
    c_on, c_off = float(f @ u_on.reshape(-1)), float(f @ u_off.reshape(-1))
    assert abs(c_on - c_off) <= 1e-10 * abs(c_off)
    res = ground_truth_topopt(cfg, dims=(16, 8, 8), max_iter=2, multigrid_levels=2,
                              dtype=torch.float64, device=device, use_kernels="auto",
                              log=lambda s: None)
    assert np.isfinite(res.history).all()
    cfg2 = dataclasses.replace(load_problem(CASES[0][0]), order_fem=(2, 2))
    prob2, grid2 = problem_from_config(cfg2, dims=(6, 2), device=device)
    rho2 = torch.full(grid2.dims, 0.5, dtype=torch.float64, device=device)
    with pytest.raises(ValueError, match="degree-1"):
        mg.make_mg_solver(prob2, settings)(rho2)
    kernels.reset_launches()
    u2, _ = mg.make_mg_solver(prob2, dataclasses.replace(
        settings, use_kernels="auto", cg_iter=2000))(rho2)
    assert bool(torch.isfinite(u2).all())
    assert kernels.launches == {name: 0 for name in kernels.launches}


@pytest.mark.parametrize("fine_kernel,dtype,rel", [
    ("flat32", torch.float32, 0.1), ("variant", torch.float32, 0.1),
    ("flat32", torch.float64, 0.1), ("flat", torch.float64, 0.1),
    ("flat32", torch.float64, 1e-9), ("flat", torch.float64, 1e-9),
])
def test_fine_kernels_refuse_asymmetric_k0(device, fine_kernel, dtype, rel):
    """The four fine kernels work in the element's reflection basis and
    raise on a K0 without that symmetry, rather than apply the wrong K;
    the float64 ones already on a coupling of 1e-9 of K0's largest, which
    their 1e-12 accuracy could not drop."""
    prob, grid = problem_from_config(load_problem(CASES[1][0]), dims=CASES[1][1],
                                     device=device)
    rng = np.random.default_rng(6)
    u = torch.tensor(rng.standard_normal(grid.nodes_per_dim + (3,)), dtype=dtype,
                     device=device)
    young = torch.ones(grid.dims, dtype=dtype, device=device)
    K0 = prob.K0.to(dtype).clone()
    K0[0, 4] += rel * float(K0.abs().max())   # a coupling outside the blocks
    K0[4, 0] = K0[0, 4]
    fine = kernels.fine_kernels(fine_kernel)[dtype == torch.float64]
    kernels.reset_launches()
    with pytest.raises(ValueError, match="reflections"):
        fine(u, young, K0, grid)
    assert kernels.launches == {name: 0 for name in kernels.launches}


@pytest.mark.parametrize("fine_kernel,fine64", [("flat32", "apply_k_fine_f64"),
                                                ("flat", "apply_k_fine_elem_f64")])
def test_f64_blocks_uploaded_once_per_problem(device, monkeypatch, fine_kernel, fine64):
    """Two cold solves of one problem with kernels on: each runs the float64
    residual at least twice, and the float64 reflection blocks are built
    and uploaded once for both (the fp32 ones once per solve, whose fp32 K0
    is a fresh tensor)."""
    built = []

    def counted(K0, ndim, dtype=torch.float32):
        built.append(dtype)
        return blocks(K0, ndim, dtype)

    blocks = kernels.reflection_blocks
    monkeypatch.setattr(kernels, "reflection_blocks", counted)
    prob, grid = problem_from_config(load_problem(CASES[3][0]), dims=CASES[3][1],
                                     dtype=torch.float32, device=device)
    rho = torch.tensor(np.random.default_rng(7).uniform(0.05, 1.0, grid.dims),
                       dtype=torch.float32, device=device)
    settings = mg.MGSolverSettings(num_levels=2, smoother="chebyshev", use_kernels=True,
                                   fine_kernel=fine_kernel)
    solve = mg.make_mg_solver(prob, settings)
    kernels.reset_launches()
    for _ in range(2):
        u, _ = solve(rho)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(u).all())
    assert kernels.launches[fine64] >= 4
    assert built.count(torch.float64) == 1
    assert built.count(torch.float32) == 2


@pytest.mark.parametrize("prob_path,dims,nl", [CASES[0] + (1,), CASES[3] + (2,),
                                               CASES[7] + (1,)])
def test_gs_sweep_with_kernels_matches_plain(device, prob_path, dims, nl):
    """fp32 GS sweeps, forward and backward, on every level: kernels on
    (the fine kernel, the cached levels' stencils and their parity apply)
    against the plain ops on the same card."""
    prob, grid = problem_from_config(load_problem(prob_path), dims=dims,
                                     dtype=torch.float32, device=device)
    cfg = mg.build_mg_config(prob, nl)
    young = prob.young(torch.tensor(np.random.default_rng(8).uniform(0.05, 1.0, grid.dims),
                                    dtype=torch.float32, device=device))
    plain = mg.build_level_states(cfg, prob, young, smoother="gs")
    kernels.reset_launches()
    kern = mg.build_level_states(cfg, prob, young, smoother="gs", use_kernels=True)
    rng = np.random.default_rng(9)
    for l in range(nl + 1):
        g = plain[l].grid
        b = torch.tensor(rng.standard_normal(g.nodes_per_dim + (g.ndim,)),
                         dtype=torch.float32, device=device)
        u = torch.tensor(rng.standard_normal(b.shape), dtype=torch.float32, device=device)
        for forward in (True, False):
            ref = mg.gs_sweep(plain[l], u, b, forward)
            assert _rel(mg.gs_sweep(kern[l], u, b, forward), ref) < 1e-5, (l, forward)
    assert kernels.launches["apply_k_fine_f32"] == 2
    if nl > 1:
        assert kernels.launches["apply_k_cached_f32"] == 2
        assert kernels.launches["cached_stencil"] >= 1


def test_mgpcg_with_transfer_level_on_card(device):
    """Level 1 forced to the transfer kind (R K_fine P through the fine
    kernel): the GS and Chebyshev solves with kernels on reach the
    plain solve's compliance."""
    prob, grid = problem_from_config(load_problem(CASES[3][0]), dims=CASES[3][1],
                                     dtype=torch.float32, device=device)
    rho = torch.tensor(np.random.default_rng(10).uniform(0.05, 1.0, grid.dims),
                       dtype=torch.float32, device=device)
    for smoother in ("gs", "chebyshev"):
        settings = mg.MGSolverSettings(num_levels=2, smoother=smoother, use_kernels=True,
                                       ke_cache_limit_bytes=1)
        solve = mg.make_mg_solver(prob, settings)
        assert solve.cfg.level_kind(1) == "transfer"
        kernels.reset_launches()
        u, iters = solve(rho)
        torch.cuda.synchronize()
        assert kernels.launches["apply_k_fine_f32"] > 0 and iters < 100
        u_ref, _ = mg.make_mg_solver(prob, dataclasses.replace(
            settings, use_kernels=False, ke_cache_limit_bytes=1400 * 2**20))(rho)
        f = prob.force.double().reshape(-1)
        c, c_ref = float(f @ u.reshape(-1)), float(f @ u_ref.reshape(-1))
        assert abs(c - c_ref) / abs(c_ref) < 1e-4, smoother


def test_profile_oc_small(device, capsys):
    profile_oc.main(["--grid", "[16,8,8]", "--mgl", "2", "--steps", "1"])
    out = capsys.readouterr().out
    for tag in ("[on]", "[off]"):
        assert f"{tag} s/OC-iter (median of 1 timed steps)" in out
        assert f"{tag} traced step wall" in out
        for span in ("oc.step", "solve", "mg.cg", "oc.bisection"):
            assert f"{tag}   span {span} " in out
        assert f"{tag}   counters per step: " in out and "host_reads" in out
    profile_oc.main(["--grid", "[16,8,8]", "--mgl", "2", "--steps", "1",
                     "--kernels", "on", "--smoother", "gs"])
    out = capsys.readouterr().out
    assert out.count("[on] GS sweep level") == 2   # the two smoothed levels
    profile_oc.main(["--grid", "[16,8,8]", "--mgl", "2", "--kernels", "on",
                     "--precond-lag", "2", "--scan", "2",
                     "--settings", '{"cached_ke_dtype": "bfloat16"}'])
    out = capsys.readouterr().out
    assert "[on] traced chunk (2 steps, per step) wall" in out
    assert "graph captures 1" in out
    profile_oc.main(["--grid", "[16,8,8]", "--mgl", "2", "--steps", "1",
                     "--kernels", "on", "--x64"])
    assert "[on] s/OC-iter (median of 1 timed steps)" in capsys.readouterr().out
    profile_oc.main(["--grid", "[16,8,8]", "--mgl", "2", "--steps", "1",
                     "--kernels", "on", "--optim", "LBFGS"])
    out = capsys.readouterr().out
    assert "[on] s per L-BFGS iteration (median of 1 timed steps)" in out
    assert "objective evaluations" in out


def test_profile_neural_small(device, capsys):
    profile_neural.main(["--grid", "[16,8,8]", "--mgl", "2", "--es", "32",
                         "--nn", "16", "--nl", "2", "--steps", "1"])
    out = capsys.readouterr().out
    assert "s/step (median of 1 timed steps)" in out
    assert "traced step wall" in out
    for span in ("neural.step", "neural.density", "solve", "neural.backward",
                 "neural.optimizer"):
        assert f"   span {span} " in out
    assert "mlp_forwards 1.00" in out


def test_wrappers_refuse_bad_inputs(device):
    prob, grid = problem_from_config(load_problem(CASES[1][0]), dims=CASES[1][1],
                                     device=device)
    u = torch.zeros(grid.nodes_per_dim + (3,), device=device)
    young = torch.ones(grid.dims, device=device)
    K0 = prob.K0.float()
    with pytest.raises(TypeError):
        kernels.apply_k_fine_f32(u.double(), young, K0, grid)
    with pytest.raises(ValueError):
        kernels.apply_k_fine_f32(u[:-1], young, K0, grid)
    strided = torch.ones(grid.dims[::-1], device=device).permute(2, 1, 0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.apply_k_fine_f32(u, strided, K0, grid)
    with pytest.raises(ValueError):
        kernels.apply_k_fine_f32(u, young.cpu(), K0, grid)
    with pytest.raises(TypeError):
        kernels.apply_k_fine_elem_f64(u, young.double(), K0.double(), grid)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.apply_k_fine_elem_f32(u, strided, K0, grid)
    Ke = torch.zeros(grid.dims + (24, 24), device=device)
    with pytest.raises(TypeError):
        kernels.cached_stencil(Ke.double(), grid)
    stencil = kernels.cached_stencil(Ke, grid)
    with pytest.raises(ValueError):
        kernels.apply_k_cached_f32(u, stencil[:-1], grid)


@pytest.mark.parametrize("fine_kernel,fine32,fine64", [
    ("variant", "apply_k_fine_elem_f32", "apply_k_fine_f64"),
    ("flat", "apply_k_fine_f32", "apply_k_fine_elem_f64"),
])
def test_neural_two_steps_on_card(device, tmp_path, fine_kernel, fine32, fine64):
    """train_xdg on the card, 2 steps through the kernels that
    ``--fine-kernel`` names; step-0 compliance as with kernels off."""
    base = ["--prob", "problems/3d/bridge.json", "--grid", "[16,8,8]", "--mgl", "2",
            "--iter", "2", "--es", "64", "--nn", "32", "--nl", "3",
            "--vcs", "maxed_barrier", "--device", "cuda", "--out", str(tmp_path),
            "--log-every", "1"]
    kernels.reset_launches()
    on = train_xdg.main(base + ["--jid", "on", "--fine-kernel", fine_kernel])
    counts = dict(kernels.launches)
    assert counts[fine32] > 0 and counts[fine64] > 0
    assert counts["apply_k_cached_f32"] > 0 and counts["cached_stencil"] > 0
    off = train_xdg.main(base + ["--jid", "off", "--kernels", "off"])
    assert np.isfinite(on.history).all() and np.isfinite(on.final_compliance)
    assert abs(on.history[0] - off.history[0]) < 1e-4 * abs(off.history[0])
    for f in ("on.vtr", "on_densities.npy", "on.npz", "on_history.json"):
        assert (tmp_path / f).exists(), f


def test_precond_from_step_matches_separate_forward_on_card(device, monkeypatch):
    """The chunked loop on the card (kernels on, bf16 products, each
    preconditioner call replayed from its CUDA graph), every step building
    the preconditioner from its own forward, against the schedule that
    built it in place from a forward pass of its own before the step: the
    same network at the same parameters on the same coordinates, so the
    same losses (the compliance, under the hard satisfier) and final
    weights to the bit. The forward goes through checkpointed chunks."""
    monkeypatch.setattr(mlp, "mlp_apply_chunked",
                        functools.partial(mlp.mlp_apply_chunked, max_points=256))
    cfg = load_problem("problems/3d/bridge.json")
    ncfg = neural.NeuralTOConfig(embedding_size=64, n_neurons=32, n_layers=3,
                                 multigrid_levels=2, use_kernels=True,
                                 matmul_precision="default")
    dims, steps = (16, 8, 8), 4
    state, train_step, aux = neural.build_trainer(cfg, ncfg, dims=dims, device="cuda")
    losses, precond = [], None
    for _ in range(steps):
        with torch.no_grad():
            rho = aux["density_fn"](state.model, aux["coords"], aux["max_volume"])
            precond = aux["solve"].build_precond(rho, into=precond, use_graph=True)
        state, m = train_step(state, precond=precond)
        losses.append(float(m["loss"]))
    weights = [p.detach().clone() for p in state.model.parameters()]
    got, history, aux = neural.train(cfg, ncfg, dims=dims, max_iter=steps, device="cuda",
                                     log=lambda s: None, scan_chunk=steps)
    st = aux["solver_stats"]
    assert st["graph_replays"] > 0 and st["mlp_forwards"] == steps
    assert st["neural.precond_from_step"] == st["hierarchy_builds"] == steps
    assert history == losses
    for p, q in zip(got.model.parameters(), weights):
        assert torch.equal(p, q)


def test_lbfgs_repeats_bitwise_on_card(device):
    """The smoothing filter's gradient gathers (no atomics) and the
    coarsest dense K adds one local node per call, so two L-BFGS runs from
    one start take the same line searches to the same bits."""
    cfg = load_problem("problems/3d/cantilever_flexion.json")
    kw = dict(dims=(32, 16, 16), max_iter=6, multigrid_levels=2, optimizer="LBFGS",
              device="cuda", log=lambda s: None)
    a = ground_truth_topopt(cfg, **kw)
    b = ground_truth_topopt(cfg, **kw)
    assert a.history == b.history and a.evaluations == b.evaluations
    assert np.array_equal(a.densities, b.densities)


@pytest.mark.parametrize("dims", [(37, 19, 23), (64, 64, 64)])
@pytest.mark.parametrize("dtype,name,tol", [(torch.float64, "apply_k_fine_f64", 1e-12),
                                            (torch.float32, "apply_k_fine_f32", 1e-5)])
def test_periodic_apply_kernel_matches_plain(device, dims, dtype, name, tol):
    """The periodic apply of a batch of six fields through the fine kernel
    of their dtype (one launch per field) against the plain periodic apply,
    on a cell of stretched (37x19x23) and cubic elements."""
    from ndr_tpu_torch.fem import element as el
    from ndr_tpu_torch.fem import homogenization as hom
    from ndr_tpu_torch.grid import make_grid

    grid = make_grid(dims, [[0, 0, 0], [1, 1, 1]])
    mat = el.IsotropicMaterial(1.0, 0.3, 3)
    K0 = torch.tensor(el.element_stiffness_matrix((1, 1, 1), grid.stretchings, mat),
                      dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    u = torch.tensor(rng.standard_normal((6,) + grid.dims + (3,)), dtype=dtype,
                     device=device)
    rho = torch.tensor(rng.uniform(0.3, 1.0, grid.dims), dtype=dtype, device=device)
    kernels.reset_launches()
    out = hom.periodic_apply_k(u, rho, K0, grid, use_kernels=True)
    torch.cuda.synchronize()
    assert kernels.launches[name] == 6 and sum(kernels.launches.values()) == 6
    ref = hom.periodic_apply_k(u, rho, K0, grid, use_kernels=False)
    assert _rel(out, ref) < tol


def test_cell_problems_on_card_match_cpu(device):
    """Homogenization of a random 16^3 cell in float64, card (the f64 fine
    kernel) against CPU: Eh and dEh within 1e-9 of their largest entries,
    CG counts within one iteration (the stop test on sums of another
    order)."""
    from ndr_tpu_torch.fem import element as el
    from ndr_tpu_torch.fem import homogenization as hom
    from ndr_tpu_torch.grid import make_grid

    grid = make_grid((16, 16, 16), [[0, 0, 0], [1, 1, 1]])
    mat = el.IsotropicMaterial(1.0, 0.3, 3)
    K0 = el.element_stiffness_matrix((1, 1, 1), grid.stretchings, mat)
    rho = np.random.default_rng(0).uniform(0.3, 1.0, grid.dims)
    kernels.reset_launches()
    Eh_c, dEh_c, it_c = hom.homogenize(torch.tensor(rho, device=device), grid, mat,
                                       torch.tensor(K0, device=device), tol=1e-10)
    assert kernels.launches["apply_k_fine_f64"] > 0
    Eh_h, dEh_h, it_h = hom.homogenize(torch.tensor(rho), grid, mat, torch.tensor(K0),
                                       tol=1e-10)
    assert _rel(Eh_c.cpu(), Eh_h) < 1e-9 and _rel(dEh_c.cpu(), dEh_h) < 1e-9
    assert (it_c.cpu() - it_h).abs().max() <= 1


def test_batched_cg_on_card_matches_cpu(device):
    """conjugate_gradient_batched on CUDA tensors against the same call on
    the CPU: equal per-column counts (a column frozen at b = 0), x within
    1e-12."""
    from ndr_tpu_torch.fem import solvers

    rng = np.random.default_rng(1)
    S, n = 4, 30
    A = np.zeros((S, n, n))
    for s, k in enumerate((4, 7, 3, 11)):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        A[s] = (Q * rng.uniform(1.0, 50.0, k)[np.arange(n) % k]) @ Q.T
    b = rng.standard_normal((S, n))
    b[2] = 0.0
    out = {}
    for dev in ("cpu", device):
        At = torch.tensor(A, device=dev)
        out[str(dev)] = solvers.conjugate_gradient_batched(
            lambda x: torch.einsum("sij,sj->si", At, x), torch.tensor(b, device=dev),
            torch.zeros(S, n, dtype=torch.float64, device=dev), tol=1e-10, max_iter=500)
    (xh, ih), (xc, ic) = out["cpu"], out[str(device)]
    assert ic.cpu().tolist() == ih.tolist() == [4, 7, 0, 11]
    assert _rel(xc.cpu(), xh) < 1e-12


def test_design_step_on_card_matches_reference(device):
    """One design_microstructure step of a seeded 16^3 cell in float64,
    the applies through the f64 fine kernel, against the benchmark's plain
    reference on the card from the step's own density and fields: their
    residual, Eh, the match gradient, the distance and rho_1 (the limits of
    the benchmark's microstructure cell)."""
    from benchmark.reference import homogenization as ref
    from ndr_tpu_torch.fem import element as el
    from ndr_tpu_torch.fem import microstructure as ms
    from ndr_tpu_torch.grid import make_grid

    dims, corners = (16, 16, 16), [[0, 0, 0], [1, 1, 1]]
    grid = make_grid(dims, corners)
    rho0 = torch.tensor(0.5 + 0.2 * (2 * np.random.default_rng(3).random(dims) - 1),
                        device=device)
    target = ref.isotropic_voigt(0.1, -0.3)
    seen = []
    kernels.reset_launches()
    ms.design_microstructure(target, grid, el.IsotropicMaterial(1.0, 0.3, 3), rho0=rho0,
                             steps=1, log=lambda s: None, callback=lambda i, s: seen.append(s))
    assert kernels.launches["apply_k_fine_f64"] > 0
    (s,) = seen
    cell = ref.Cell.make(dims, corners, 1.0, 0.3, device=device)
    T = torch.tensor(target, device=device)
    got = ref.judge_step(cell, T, s.rho, s.w, s.Eh, s.grad, s.distance)
    assert got["residual"] < 1e-8, got
    assert max(got["eh"], got["grad"], got["distance"]) < 1e-10, got
    kept = [{"rho": s.rho, "w": s.w, "rho_next": s.rho_next}]
    assert ref.update_gap(cell, T, rho0, kept, 0.05, 1e-3) < 1e-10


# the local grids of the sharded solver: slabs and pencils of the smoke's
# 192x96x96 and of a small grid
LOCAL_CASES = [((192, 96, 96), (2,)), ((192, 96, 96), (2, 2)),
               ((32, 16, 16), (4,)), ((32, 16, 16), (2, 2))]


@pytest.mark.parametrize("dims,shape", LOCAL_CASES)
def test_fine_kernels_on_local_grids(device, dims, shape):
    """apply_k_fine_f32 / _f64 on every shard's local block (slab
    (L, ny, nz), pencil (Lx, Ly, nz)) of the same global fields, against
    the twin; one launch each per block."""
    from ndr_tpu_torch.parallel import mesh as pm

    prob, grid = problem_from_config(load_problem("problems/3d/cantilever_flexion.json"),
                                     dims=dims, device=device)
    sg = pm.ShardedGrid(grid, *shape) if len(shape) == 1 else pm.ShardedGrid2D(grid, *shape)
    rng = np.random.default_rng(1)
    u = torch.tensor(rng.standard_normal(grid.nodes_per_dim + (3,)), device=device)
    young = prob.young(torch.tensor(rng.uniform(1e-3, 1.0, grid.dims), device=device))
    K32 = prob.K0.float()
    kernels.reset_launches()
    for c in np.ndindex(*shape):
        u_l, y_l = pm.node_block(u, sg, c), pm.elem_block(young, sg, c)
        assert y_l.shape == sg.local_dims
        f32 = kernels.apply_k_fine_f32(u_l.float(), y_l.float(), K32, sg.local_grid)
        f64 = kernels.apply_k_fine_f64(u_l, y_l, prob.K0, sg.local_grid)
        torch.cuda.synchronize()
        assert _rel(f32, kernels.apply_k_fine_plain(u_l.float(), y_l.float(), K32,
                                                    sg.local_grid)) < 1e-5
        assert _rel(f64, kernels.apply_k_fine_plain(u_l, y_l, prob.K0,
                                                    sg.local_grid)) < 1e-12
    n = int(np.prod(shape))
    assert kernels.launches["apply_k_fine_f32"] == kernels.launches["apply_k_fine_f64"] == n


def test_one_rank_sharded_solve_on_card_matches_cpu(device):
    """make_sharded_solver on a one-rank mesh (no process group) with the
    kernels on the card against the same solve on the CPU."""
    from ndr_tpu_torch.parallel import mesh as pm

    cfg = load_problem("problems/3d/bridge.json")
    rho = np.random.default_rng(2).uniform(0.05, 1.0, (32, 16, 16))
    out = {}
    for dev in (device, torch.device("cpu")):
        prob, _ = problem_from_config(cfg, dims=(32, 16, 16), device=dev,
                                      dtype=torch.float32)
        kernels.reset_launches()
        solve = pm.make_sharded_solver(prob, 1, 2, tol=1e-8, use_kernels=True)
        out[dev.type] = solve(torch.tensor(rho, dtype=torch.float32, device=dev))[0].cpu()
        if dev.type == "cuda":
            assert kernels.launches["apply_k_fine_f32"] > 0
            assert kernels.launches["apply_k_fine_f64"] > 0
    assert _rel(out["cuda"], out["cpu"]) < 1e-6
