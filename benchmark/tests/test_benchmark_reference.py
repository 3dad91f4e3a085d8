"""The plain reference against the program on the CPU at small sizes: the
problem, the operator and the gradient to round-off, the V-cycle PCG to
its tolerance, the OC update of a float64 program run to its volume
tolerance, and the network's drawing bit for bit."""

import json
import tempfile

import numpy as np
import pytest
import torch

from benchmark.harness.program import write_problem
from benchmark.reference import classic, fem, neural, solve

from conftest import REPO


def _config(name, dims):
    c = json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())
    c["grid"] = list(dims)
    return c


def _program_problem(config):
    from ndr_tpu_torch.fem.simulator import problem_from_config
    from ndr_tpu_torch.io.problem import load_problem

    with tempfile.TemporaryDirectory() as d:
        cfg = load_problem(write_problem(config, d))
        return problem_from_config(cfg, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("name", ["c3d256", "ns192"])
def test_problem_operator_and_gradient_match_the_program(name):
    from ndr_tpu_torch.fem import operators as ops

    config = _config(name, (12, 8, 4))
    rp = fem.build_problem(config, device="cpu")
    pp, grid = _program_problem(config)
    assert float((rp.K0 - pp.K0).abs().max()) < 1e-15
    assert torch.equal(rp.force, pp.force) and torch.equal(rp.fixed, pp.dirichlet_mask)
    g = torch.Generator().manual_seed(3)
    u = torch.rand(rp.force.shape, generator=g, dtype=torch.float64)
    rho = torch.rand(rp.dims, generator=g, dtype=torch.float64)
    a = fem.apply_k(rp, fem.young(rp, rho), u, slab=5)
    b = ops.apply_k(u, pp.young(rho), pp.K0, grid)
    assert float((a - b).abs().max() / b.abs().max()) < 1e-14
    ga = fem.compliance_grad_rho(rp, rho, u)
    gb = 2 * ops.compliance_gradient(u, rho, pp.K0, grid, pp.E0, pp.Emin, pp.gamma)
    assert float((ga - gb).abs().max() / gb.abs().max()) < 1e-14


def test_vcycle_pcg_reaches_its_tolerance():
    rp = fem.build_problem(_config("ns192", (32, 16, 16)), device="cpu")
    rho = 0.2 + 0.8 * torch.rand(rp.dims, generator=torch.Generator().manual_seed(1),
                                 dtype=torch.float64)
    u, iters, rel = solve.solve(rp, rho, 1e-10)
    assert rel <= 1e-10 and iters < 60
    assert fem.residual(rp, rho, u) < 2e-10


def test_oc_update_follows_a_float64_program_run():
    from ndr_tpu_torch.io.problem import load_problem
    from ndr_tpu_torch.training.classic import ground_truth_topopt

    config = _config("c3d256", (16, 8, 8))
    rp = fem.build_problem(config, device="cpu")
    x0 = (0.5 + 1e-3 * (2 * np.random.default_rng(5).random((16, 8, 8)) - 1)).astype(np.float32)
    seen, prev = [], [torch.as_tensor(x0)]

    def cb(i, s):
        seen.append((prev[0], s.u, s.x))
        prev[0] = s.x

    with tempfile.TemporaryDirectory() as d:
        ground_truth_topopt(load_problem(write_problem(config, d)), dims=(16, 8, 8),
                            max_iter=4, multigrid_levels=2, init=x0, log=lambda s: None,
                            callback=cb, device="cpu", dtype=torch.float64)
    for x, u, x_next in seen:
        assert classic.judge_step(rp, x, u, x_next, 1, 1.0, 0.2)["residual"] <= 1e-4
        ref = classic.oc_update(rp, x.double(), u, 1, 1.0, 0.2)
        # the program's bisection stops at a volume within 1e-6
        assert float((x_next - ref).abs().max()) < 5e-6


def test_network_is_drawn_as_the_program_draws_it():
    from ndr_tpu_torch.models import mlp

    cfg = mlp.MLPConfig(in_features=3, out_features=1, n_neurons=16, n_layers=3,
                        embedding_size=32, scale=1.0)
    model = mlp.homogeneous_init(mlp.init_mlp(cfg, torch.Generator().manual_seed(2**33 + 5),
                                              device="cpu"), 0.4)
    net = neural.init(2**33 + 5, 32, 16, 3, 1.0, 0.4, "cpu")
    assert torch.equal(net.B, model.B)
    for p, q in zip(net.params, model.parameters()):
        assert torch.equal(p, q)
    x = neural.coordinates((6, 4, 3), "cpu")
    assert torch.allclose(neural.forward(net, x, net.params), model(x)[:, 0], atol=1e-6)


def test_adam_is_torch_adam():
    g = torch.Generator().manual_seed(0)
    p = [torch.randn(5, 3, generator=g), torch.randn(3, generator=g)]
    q = [t.clone().requires_grad_(True) for t in p]
    opt, ref = torch.optim.Adam(q, lr=3e-4), neural.Adam(p, 3e-4)
    for _ in range(3):
        grads = [torch.randn(t.shape, generator=g) for t in p]
        for t, gr in zip(q, grads):
            t.grad = gr.clone()
        opt.step()
        p = ref.step(p, grads)
    for a, b in zip(p, q):
        assert torch.allclose(a, b.detach(), rtol=0, atol=1e-7)
