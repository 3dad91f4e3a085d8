"""ndr_tpu_torch plain operators and problem setup vs the JAX package.

Same inputs (numpy, seeded) through ``ndr_tpu`` and its PyTorch port, in
float64 on the CPU. The plain ops are the oracles the CUDA kernels are
held to, so they are held to the JAX ops at 1e-12 of max|f| (only the
summation order differs).
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.fem import operators as jops
from ndr_tpu.fem import topopt as jtopopt
from ndr_tpu.fem.simulator import problem_from_config as j_problem_from_config
from ndr_tpu.io.problem import load_problem
from ndr_tpu_torch.fem import operators as tops
from ndr_tpu_torch.grid import Grid as TGrid
from ndr_tpu_torch.io.problem import load_problem as t_load_problem
from ndr_tpu_torch.fem import topopt as ttopopt
from ndr_tpu_torch.fem.simulator import problem_from_config as t_problem_from_config
from ndr_tpu_torch.fem.simulator import problem_from_numpy
from ndr_tpu_torch.utils.torch_setup import resolve_device

CASES = [
    ("problems/2d/mbb_beam.json", (12, 6)),
    ("problems/3d/cantilever_flexion.json", (8, 4, 4)),
    ("problems/3d/cantilever_flexion.json", (6, 4, 2)),
]
OPS = ["apply_k", "apply_k_cached", "node_diag_blocks", "invert_blocks",
       "compliance_gradient"]


def _port_grid(grid) -> TGrid:
    """The port's Grid with the fields of a JAX-side Grid."""
    return TGrid(**dataclasses.asdict(grid))


def _problems(prob_path, dims):
    """(JAX problem, port problem on the CPU, JAX grid) from one config."""
    pj, grid = j_problem_from_config(load_problem(prob_path), dims=dims,
                                     dtype=jnp.float64)
    pt, _ = t_problem_from_config(t_load_problem(prob_path), dims=dims,
                                  dtype=torch.float64, device="cpu")
    return pj, pt, grid


def test_port_imports_without_jax():
    """The port, its CLIs (the eval ones too), the L-BFGS, calculus and
    memory modules, homogenization and microstructure design, the
    continual-learning trainer, the model zoo, datasets, history, the
    sharded solver with its launcher, checks and dry run, the native IO,
    the plots and chip_smoke's imports load neither JAX, optax nor any
    module of the JAX package; nor matplotlib, which the plots import
    when they draw."""
    code = ("import sys, ndr_tpu_torch.training.train_xdg, "
            "ndr_tpu_torch.training.train_voxelfem, ndr_tpu_torch.fem.kernels, "
            "ndr_tpu_torch.utils.profile_oc, ndr_tpu_torch.utils.profile_neural, "
            "ndr_tpu_torch.eval.evaluate, ndr_tpu_torch.eval.eval_voxelfem, "
            "ndr_tpu_torch.eval.eval_fourfeat, ndr_tpu_torch.eval.fourfeat_utils, "
            "ndr_tpu_torch.ops.lbfgs, ndr_tpu_torch.ops.calculus, "
            "ndr_tpu_torch.utils.memory, "
            "ndr_tpu_torch.fem.homogenization, ndr_tpu_torch.fem.microstructure, "
            "ndr_tpu_torch.training.train_cl, ndr_tpu_torch.models.siren, "
            "ndr_tpu_torch.models.cnn, ndr_tpu_torch.training.datasets, "
            "ndr_tpu_torch.utils.history, "
            "ndr_tpu_torch.parallel.mesh, ndr_tpu_torch.parallel.launch, "
            "ndr_tpu_torch.parallel.checks, ndr_tpu_torch.parallel.dryrun, "
            "ndr_tpu_torch.io.native, ndr_tpu_torch.utils.visualizations, "
            "chip_smoke; "
            "chip_smoke.port_modules(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'ndr_tpu', 'matplotlib')]; "
            "assert not bad, bad; print('ok')")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("prob_path,dims", CASES)
def test_plain_op_matches_jax(prob_path, dims, op):
    pj, pt, grid = _problems(prob_path, dims)
    rng = np.random.default_rng(0)
    rho = rng.uniform(0.1, 1.0, grid.dims)
    young = np.asarray(pj.young(jnp.asarray(rho)))
    u = rng.standard_normal(grid.nodes_per_dim + (grid.ndim,))
    K0 = np.asarray(pj.K0)
    d = K0.shape[0]
    T = lambda a: torch.tensor(np.asarray(a))
    tg = pt.grid
    if op == "apply_k":
        ref = jops.apply_k(jnp.asarray(u), jnp.asarray(young), pj.K0, grid)
        out = tops.apply_k(T(u), T(young), pt.K0, tg)
    elif op == "apply_k_cached":
        A = rng.standard_normal(grid.dims + (d, d))
        Ke = A + np.swapaxes(A, -1, -2)
        ref = jops.apply_k_cached(jnp.asarray(u), jnp.asarray(Ke), grid)
        out = tops.apply_k_cached(T(u), T(Ke), tg)
    elif op == "node_diag_blocks":
        ref = jops.node_diag_blocks(jnp.asarray(young), pj.K0, grid)
        out = tops.node_diag_blocks(T(young), pt.K0, tg)
    elif op == "invert_blocks":
        M = np.asarray(jops.node_diag_blocks(jnp.asarray(young), pj.K0, grid))
        ref = jops.invert_blocks(jnp.asarray(M))
        out = tops.invert_blocks(T(M))
    else:
        ref = jops.compliance_gradient(jnp.asarray(u), jnp.asarray(rho), pj.K0,
                                       grid, pj.E0, pj.Emin, pj.gamma)
        out = tops.compliance_gradient(T(u), T(rho), pt.K0, tg,
                                       pt.E0, pt.Emin, pt.gamma)
    ref = np.asarray(ref)
    assert out.dtype == torch.float64 and tuple(out.shape) == ref.shape
    err = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert err < 1e-12, err


@pytest.mark.parametrize("prob_path,dims", CASES)
def test_dense_assembly_matches_jax(prob_path, dims):
    """The coarsest level's dense K, assembled one local node at a time
    (no two adds of one call share a target), against the JAX package's
    single scatter-add over all elements: float64, summed in another
    order, within 1e-14 of max|K|."""
    from ndr_tpu.fem import solvers as jsolvers
    from ndr_tpu_torch.fem import solvers as tsolvers

    grid = j_problem_from_config(load_problem(prob_path), dims=dims, dtype=jnp.float64)[1]
    d = grid.nodes_per_elem * grid.ndim
    ke = np.random.default_rng(5).standard_normal(grid.dims + (d, d))
    kj = np.asarray(jsolvers.assemble_dense_k_traced(jnp.asarray(ke), grid))
    kt = tsolvers.assemble_dense_k_traced(torch.tensor(ke), _port_grid(grid)).numpy()
    np.testing.assert_allclose(kt, kj, rtol=0, atol=1e-14 * np.abs(kj).max())


@pytest.mark.parametrize("prob_path,dims", [CASES[0], CASES[1]])
def test_problem_from_config_matches_jax(prob_path, dims):
    pj, pt, grid = _problems(prob_path, dims)
    assert pj.grid == grid and pt.grid == _port_grid(grid)
    assert isinstance(pt.grid, TGrid)
    assert pt.K0.dtype == torch.float64
    np.testing.assert_array_equal(pt.K0.numpy(), np.asarray(pj.K0))
    np.testing.assert_array_equal(pt.force.numpy(), np.asarray(pj.force))
    np.testing.assert_array_equal(pt.dirichlet_mask.numpy(),
                                  np.asarray(pj.dirichlet_mask))
    assert (pt.E0, pt.Emin, pt.gamma) == (pj.E0, pj.Emin, pj.gamma)
    # working dtype of the force field; K0 stays float64
    p32, _ = t_problem_from_config(t_load_problem(prob_path), dims=dims,
                                   dtype=torch.float32, device="cpu")
    assert p32.force.dtype == torch.float32 and p32.K0.dtype == torch.float64


def test_state_carry_converters():
    pj, _, grid = _problems(*CASES[1])
    pt = problem_from_numpy(np.asarray(pj.K0), np.asarray(pj.force),
                            np.asarray(pj.dirichlet_mask), _port_grid(grid),
                            pj.E0, pj.Emin, pj.gamma, device="cpu")
    np.testing.assert_array_equal(pt.K0.numpy(), np.asarray(pj.K0))
    np.testing.assert_array_equal(pt.force.numpy(), np.asarray(pj.force))
    np.testing.assert_array_equal(pt.dirichlet_mask.numpy(),
                                  np.asarray(pj.dirichlet_mask))
    rng = np.random.default_rng(2)
    sj = jtopopt.OCState(
        x=jnp.asarray(rng.uniform(0, 1, grid.dims), jnp.float32),
        u=jnp.asarray(rng.standard_normal(grid.nodes_per_dim + (3,))),
        lambda_min=jnp.asarray(0.75, jnp.float32),
        lambda_max=jnp.asarray(1.5, jnp.float32))
    st = ttopopt.oc_state_from_numpy(
        {f: np.asarray(getattr(sj, f))
         for f in ("x", "u", "lambda_min", "lambda_max")}, device="cpu")
    assert st.x.dtype == torch.float32 and st.u.dtype == torch.float64
    np.testing.assert_array_equal(st.x.numpy(), np.asarray(sj.x))
    np.testing.assert_array_equal(st.u.numpy(), np.asarray(sj.u))
    assert (st.lambda_min, st.lambda_max) == (0.75, 1.5)


def test_cuda_device_never_falls_back():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
