"""The last public functions of ``ndr_tpu`` ported to ``ndr_tpu_torch``,
held to the JAX package on the CPU: the total-volume constraint's
gradient, the Galerkin level stiffnesses (float64, rounding: 1e-12),
``NeuralState``, the ``trace`` context, ``launch.spawn``'s device and the
single-card ``entry()`` against ``__graft_entry__.entry()`` (float32, both
solves refined to tol 1e-4, so the compliances and the gradients meet at
1e-4).
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ndr_tpu import models as jmodels
from ndr_tpu.fem import multigrid as jmg
from ndr_tpu.fem import topopt as jtopopt
from ndr_tpu.fem.simulator import problem_from_config as j_problem_from_config
from ndr_tpu.io.problem import load_problem
from ndr_tpu.ops import volume as jvol
from ndr_tpu_torch.fem import multigrid as tmg
from ndr_tpu_torch.fem.simulator import problem_from_config as t_problem_from_config
from ndr_tpu_torch.io.problem import load_problem as t_load_problem
from ndr_tpu_torch.models import mlp
from ndr_tpu_torch.ops import volume as tvol
from ndr_tpu_torch.parallel import dryrun, launch
from ndr_tpu_torch.training import neural
from ndr_tpu_torch.utils import timers

TOL_ROUNDING = 1e-12
TOL_ENTRY = 1e-4   # the entry's solve tolerance


@pytest.mark.parametrize("shape,max_volume", [((12, 5), 0.3), ((6, 4, 3), 0.45)])
def test_total_volume_constraint_grad_matches_jax(shape, max_volume):
    rho = np.random.default_rng(3).uniform(0.0, 1.0, shape)
    ref = np.asarray(jvol.total_volume_constraint_grad(jnp.asarray(rho), max_volume))
    out = tvol.total_volume_constraint_grad(torch.tensor(rho), max_volume)
    assert out.dtype == torch.float64 and out.shape == shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL_ROUNDING, atol=0)


def test_build_level_stiffness_matches_jax():
    """Levels 1 and 2 of the cantilever 8x4x4 from one random density."""
    path, dims, mgl = "problems/3d/cantilever_flexion.json", (8, 4, 4), 2
    pj, grid = j_problem_from_config(load_problem(path), dims=dims, dtype=jnp.float64)
    pt, _ = t_problem_from_config(t_load_problem(path), dims=dims, dtype=torch.float64,
                                  device="cpu")
    rho = np.random.default_rng(5).uniform(0.05, 1.0, grid.dims)
    ref = jmg.build_level_stiffness(jmg.build_mg_config(pj, mgl), pj.young(jnp.asarray(rho)))
    out = tmg.build_level_stiffness(tmg.build_mg_config(pt, mgl), pt.young(torch.tensor(rho)))
    assert len(out) == len(ref) == mgl
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), r, rtol=TOL_ROUNDING,
                                   atol=TOL_ROUNDING * np.abs(r).max())


def test_neural_state_alias():
    assert neural.NeuralState is neural.NeuralTOState


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.rand(64, 64, dtype=torch.float64)
    with timers.trace(str(tmp_path / "trace"), device="cpu") as path:
        (x @ x).sum()
    assert os.path.dirname(path) == str(tmp_path / "trace")
    assert os.path.getsize(path) > 0
    with open(path) as f:
        assert '"traceEvents"' in f.read()


def test_spawn_defaults_to_the_card():
    """Ranks run on the card unless the caller asks for the CPU."""
    assert inspect.signature(launch.spawn).parameters["device"].default == "cuda"


def _jax_entry_value_and_grad(params, buffers, coords):
    """``__graft_entry__.entry()``'s forward with the solve's input held
    constant (its CG loop cannot be reverse-differentiated; the adjoint
    in ``compliance_with_adjoint`` carries the gradient, as in the JAX
    trainers): the compliance and its gradient in the parameters."""
    cfg, prob, _, mlp_cfg, _, _, _ = graft._problem_and_model(dryrun.ENTRY_DIMS)
    solve = jmg.make_mg_solver(prob, jmg.MGSolverSettings(
        num_levels=1, cg_iter=30, tol=1e-4, smoother="chebyshev"))

    def forward(params):
        out = jmodels.mlp_apply(params, buffers, coords, mlp_cfg)[..., 0]
        rho = jvol.sigmoid_with_constrained_mean(out, jnp.asarray(cfg.max_volume,
                                                                  jnp.float32))
        u, _ = solve(jax.lax.stop_gradient(rho), None)
        return 2.0 * jtopopt.compliance_with_adjoint(rho, u, prob)

    return jax.value_and_grad(forward)(params)


@pytest.mark.parametrize("last_scale", [1.0, 1e3])
def test_entry_matches_jax(last_scale):
    """The port's entry() with the JAX entry's parameters carried across:
    the same compliance as ``__graft_entry__.entry()`` and the same
    gradient in every parameter. As drawn, the homogeneous init makes the
    first field near uniform whatever the hidden layers compute (the
    seeded network's compliance is the carried one's); with the last
    layer's weights scaled by 1e3 the field varies."""
    fj, (params, buffers, coords) = graft.entry()
    layers = list(params["layers"])
    layers[-1] = dict(layers[-1], w=layers[-1]["w"] * last_scale)
    params = {"layers": layers}
    ref = float(fj(params, buffers, coords))
    ref_vg, ref_grads = _jax_entry_value_and_grad(params, buffers, coords)
    assert float(ref_vg) == ref
    ft, (model, coords_t) = dryrun.entry(device="cpu")
    np.testing.assert_allclose(coords_t.numpy(), np.asarray(coords), rtol=0, atol=1e-7)
    seeded = float(ft(model, coords_t).detach())
    model.load_state_dict(mlp.params_from_jax(params, buffers))
    c = ft(model, coords_t)
    c.backward()
    assert abs(float(c.detach()) - ref) <= TOL_ENTRY * abs(ref), (float(c.detach()), ref)
    ref_grads = mlp.params_from_jax(ref_grads, buffers)
    names = [n for n, _ in model.named_parameters()]
    for name, p in model.named_parameters():
        r = ref_grads[name].numpy()
        # the last bias's exact gradient is 0 (the constrained mean makes the
        # field blind to a shift of the output): hold its rounding against
        # the last weight's gradient
        scale = np.abs(ref_grads[names[-2]].numpy() if name == names[-1] else r).max()
        err = np.abs(p.grad.numpy() - r).max() / scale
        assert err <= TOL_ENTRY, (name, err)
    if last_scale == 1.0:
        assert abs(seeded - ref) <= TOL_ENTRY * abs(ref), (seeded, ref)
    else:  # the scaled field is no longer uniform: another compliance
        assert abs(seeded - ref) > 100 * TOL_ENTRY * abs(ref), (seeded, ref)
