"""The evaluation package of ndr_tpu_torch vs ``ndr_tpu.eval`` (CPU).

``evaluate_density`` agrees with JAX in float64 to rounding, held to
1e-9 (``evaluate_model_at_resolution``: ``test_torch_eval_model.py``);
:func:`evaluate.resize` is ``jax.image.resize``
for nearest, linear and cubic, up and down, 2-D and 3-D, held to 1e-12;
a 5-step ``compare_interpolation`` fit gives JAX's PSNRs to 1e-6. Both
CLIs run with ``--device cpu`` on a checkpoint and densities that the
port's ``train_xdg`` wrote.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu import models as jmodels
from ndr_tpu.eval import evaluate as jeval
from ndr_tpu.eval import fourfeat_utils as jff
from ndr_tpu.io.problem import load_problem
from ndr_tpu_torch.eval import eval_fourfeat, eval_voxelfem
from ndr_tpu_torch.eval import evaluate as teval
from ndr_tpu_torch.eval import fourfeat_utils as tff
from ndr_tpu_torch.io.problem import load_problem as t_load_problem
from ndr_tpu_torch.models import mlp as tmlp
from ndr_tpu_torch.training import train_xdg

MBB = "problems/2d/mbb_beam.json"
RTOL = 1e-9


def _assert_same(rt, rj):
    for k in ("compliance", "binary_compliance", "binary_volume"):
        assert getattr(rt, k) == pytest.approx(getattr(rj, k), rel=RTOL, abs=0), k
    np.testing.assert_allclose(rt.density, np.asarray(rj.density), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dims", [(16, 8), (24, 8)])
def test_evaluate_density_matches_jax(dims):
    density = np.random.default_rng(0).uniform(0.2, 0.8, size=dims)
    rj = jeval.evaluate_density(load_problem(MBB), density, multigrid_levels=1, tol=1e-7)
    rt = teval.evaluate_density(t_load_problem(MBB), density, multigrid_levels=1,
                                tol=1e-7, device="cpu")
    _assert_same(rt, rj)
    assert min(rt.cg_iters) > 0


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize("shape,new", [
    ((8, 6), (16, 12)), ((16, 12), (7, 5)), ((9, 4), (4, 10)),
    ((6, 4, 5), (12, 8, 10)), ((12, 8, 10), (5, 3, 4)),
], ids=["2d-up", "2d-down", "2d-mixed", "3d-up", "3d-down"])
def test_resize_matches_jax_image_resize(shape, new, method):
    x = np.random.default_rng(1).standard_normal(shape)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), new, method=method))
    out = teval.resize(torch.tensor(x), new, method=method).numpy()
    assert out.shape == new
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    if method == "linear":
        up = teval.upsample_density(torch.tensor(x), new).numpy()
        np.testing.assert_allclose(up, np.asarray(jeval.upsample_density(jnp.asarray(x), new)),
                                   rtol=0, atol=1e-12 * np.abs(ref).max())


def test_compare_interpolation_matches_jax():
    """5 Adam steps on a 16x16 image: the FF fit's PSNR and the three
    upsamplings' PSNRs (fp32, as in JAX)."""
    img = np.random.default_rng(2).uniform(size=(16, 16)).astype(np.float32)
    quiet = lambda s: None
    rj = jff.compare_interpolation(img, steps=5, log=quiet)
    cfg = tmlp.MLPConfig(in_features=2, out_features=1, n_neurons=256, n_layers=4,
                         embedding_size=256, scale=10.0, output_activation="sigmoid")
    jcfg = jmodels.MLPConfig(in_features=2, out_features=1, n_neurons=256, n_layers=4,
                             embedding_size=256, scale=10.0, output_activation="sigmoid")
    params, buffers = jmodels.init_mlp(jax.random.PRNGKey(0), jcfg)
    model = tmlp.FourierFeatureMLP(cfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(tmlp.params_from_jax(params, buffers))
    rt = tff.compare_interpolation(img, steps=5, model=model, device="cpu", log=quiet)
    assert set(rt) == set(rj) == {"fourfeat", "nearest", "linear", "cubic"}
    for k in rj:
        assert rt[k] == pytest.approx(rj[k], rel=1e-6), k


def test_eval_clis_on_cpu(tmp_path, capsys):
    """``train_xdg`` writes a checkpoint and densities; both eval CLIs
    read them, on a finer grid, and print one JSON line each."""
    out = tmp_path / "xdg"
    train_xdg.main(["--device", "cpu", "--prob", MBB, "--grid", "[24,8]", "--mgl", "1",
                    "--iter", "2", "--es", "16", "--nn", "16", "--nl", "2",
                    "--vcs", "constrained_sigmoid", "--out", str(out), "--jid", "run"])
    capsys.readouterr()
    r = eval_fourfeat.main(["--device", "cpu", "--prob", MBB, "--checkpoint",
                            str(out / "run.npz"), "--grid", "[48,16]", "--es", "16",
                            "--nn", "16", "--nl", "2", "--mgl", "2",
                            "--out", str(tmp_path / "ff")])
    cap = capsys.readouterr()
    line = json.loads(cap.out.strip().splitlines()[-1])
    assert set(line) == {"test_resolution", "compliance", "binary_compliance",
                         "binary_volume"}
    assert line["test_resolution"] == [48, 16]
    assert "Loaded checkpoint (sigma=" in cap.err
    assert line["compliance"] == r.compliance > 0 and r.binary_compliance > 0
    assert abs(float(np.mean(r.density)) - t_load_problem(MBB).max_volume) < 1e-6
    assert np.load(tmp_path / "ff_densities.npy").shape == (48, 16)

    r = eval_voxelfem.main(["--device", "cpu", "--prob", MBB, "--densities",
                            str(out / "run_densities.npy"), "--upsample", "[48,16]",
                            "--mgl", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"resolution", "compliance", "binary_compliance", "binary_volume"}
    assert line["resolution"] == [48, 16]
    assert line["compliance"] == r.compliance > 0 and 0 <= r.binary_volume <= 1
    if not torch.cuda.is_available():
        for cli, args in ((eval_voxelfem, ["--densities", str(out / "run_densities.npy")]),
                          (eval_fourfeat, ["--checkpoint", str(out / "run.npz"),
                                           "--grid", "[48,16]"])):
            with pytest.raises(RuntimeError, match="--device cpu"):
                cli.main(["--prob", MBB] + args)        # --device defaults to cuda
