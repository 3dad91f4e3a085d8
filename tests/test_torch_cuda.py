"""The CUDA stiffness kernels vs their plain twins, on the card.

Needs an NVIDIA card with ``nvcc`` (an sm_90a build); each test skips
where ``torch.cuda.is_available()`` is False. This file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from ndr_tpu_torch.fem import kernels
from ndr_tpu_torch.fem import multigrid as mg
from ndr_tpu_torch.fem.simulator import problem_from_config
from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.training import train_xdg
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
                                "apply_k_fine_f64": 1, "apply_k_fine_elem_f64": 1}


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
    """Kernels on for a float64 CUDA hierarchy raise rather than run the
    plain ops on the card; kernels off is an explicit choice of them."""
    cfg = load_problem(CASES[1][0])
    for use_kernels in (True, "auto"):
        with pytest.raises(NotImplementedError, match="Queue 2 item 6"):
            ground_truth_topopt(cfg, dims=(8, 4, 4), max_iter=1,
                                multigrid_levels=1, dtype=torch.float64,
                                device=device, use_kernels=use_kernels,
                                log=lambda s: None)
    prob, grid = problem_from_config(cfg, dims=(8, 4, 4), dtype=torch.float64,
                                     device=device)
    settings = mg.MGSolverSettings(num_levels=1, smoother="chebyshev",
                                   use_kernels=True)
    rho = torch.full(grid.dims, 0.5, dtype=torch.float64, device=device)
    with pytest.raises(NotImplementedError, match="Queue 2 item 6"):
        mg.make_mg_solver(prob, settings)(rho)
    kernels.reset_launches()
    u, _ = mg.make_mg_solver(
        prob, dataclasses.replace(settings, use_kernels=False))(rho)
    assert u.dtype == torch.float64 and bool(torch.isfinite(u).all())
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
        assert f"{tag} s/OC-iter with synced sections" in out
        assert f"{tag} traced step wall" in out
        assert f"{tag}   solve total" in out
    profile_oc.main(["--grid", "[16,8,8]", "--mgl", "2", "--steps", "1",
                     "--kernels", "on", "--smoother", "gs"])
    out = capsys.readouterr().out
    assert out.count("[on] GS sweep level") == 2   # the two smoothed levels


def test_profile_neural_small(device, capsys):
    profile_neural.main(["--grid", "[16,8,8]", "--mgl", "2", "--es", "32",
                         "--nn", "16", "--nl", "2", "--steps", "1"])
    out = capsys.readouterr().out
    assert "s/step with synced sections" in out
    assert "traced step wall" in out
    for label, *_ in profile_neural.SECTIONS:
        assert label in out


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
