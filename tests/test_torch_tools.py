"""The JAX repo's reproduction and measurement tools ported to
``ndr_tpu_torch``, held on the CPU to the scripts they replace:
``scripts/reproduce.sh`` (the five runs' arguments, read from the shell
script), ``scripts/mg_benchmark.py`` + ``scripts/envelope_table.py`` (the
density fields against the JAX package's filter in float64 at rounding,
1e-12; the sweep's shape; the table's markdown), ``scripts/
neural_throughput.py`` (its configurations) and ``scripts/
validate_parallel_2d.py`` (two ranks over gloo).
"""

import json
import os
import shlex
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndr_tpu.ops import filters as jflt
from ndr_tpu_torch.fem import multigrid as tmg
from ndr_tpu_torch.fem.simulator import problem_from_config
from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.training import classic, neural
from ndr_tpu_torch.parallel import validate_2d
from ndr_tpu_torch.utils import mg_benchmark, neural_throughput, reproduce

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENVELOPE = os.path.join(ROOT, "logs", "mg_envelope_64x32x32_f100_cpu.json")


def _shell_runs():
    """{jid: (CLI module, argv)} of every python command of reproduce.sh."""
    with open(os.path.join(ROOT, "scripts", "reproduce.sh")) as f:
        text = f.read().replace("\\\n", " ")
    runs = {}
    for line in text.splitlines():
        words = shlex.split(line, comments=True)
        if words[:2] == ["python", "-m"]:
            argv = words[3:]
            runs[argv[argv.index("--jid") + 1]] = (words[2].rsplit(".", 1)[1], argv)
    return runs


def test_reproduce_runs_are_the_shell_scripts():
    assert reproduce.RUNS == _shell_runs()
    assert set(reproduce.REFERENCE) == set(reproduce.RUNS)


def test_reproduce_overrides():
    argv = reproduce.run_argv("c3d_256", iters=20, grid="[16,8,8]", device="cpu",
                              out="/tmp/x", x64=True)
    assert argv[argv.index("--iter") + 1] == "20"
    assert argv[argv.index("--grid") + 1] == "[16,8,8]"
    assert argv[-5:] == ["--device", "cpu", "--out", "/tmp/x", "--x64"]
    # a run without --grid gets one appended
    argv = reproduce.run_argv("mbb300", grid="[30,10]")
    assert argv[argv.index("--grid") + 1] == "[30,10]"
    assert reproduce.run_argv("mbb300")[-4:] == ["--device", "cuda", "--out",
                                                 "build/reproduce"]


@pytest.mark.parametrize("jid,cap", [("mbb300", 100), ("bridge250", 2000),
                                     ("c3d_256", 100), ("ff3d", 100)])
def test_reproduce_cg_caps(jid, cap):
    """250x125 cannot coarsen: block-Jacobi CG with its 2000 cap."""
    assert reproduce.cg_cap(jid, reproduce.run_argv(jid)) == cap


def test_reproduce_short_run_on_cpu(tmp_path, capsys):
    recs = reproduce.main(["--only", "mbb300", "--iter", "3", "--grid", "[30,10]",
                           "--device", "cpu", "--out", str(tmp_path)])
    (rec,) = recs
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith('{"jid": "mbb300"')
    assert rec["steps"] == 3 and rec["device"] == "cpu" and rec["peak_gib"] is None
    for k in ("compliance", "binary_compliance", "last_step_compliance"):
        assert np.isfinite(rec[k]) and rec[k] > 0
    assert 0 < rec["cg_iters"]["max"] < rec["cg_iters"]["cap"]
    assert rec["cg_iters"]["longest_run_at_cap"] == rec["cg_iters"]["passes_at_cap"] == 0
    # the per-step record behind the two: one count per step
    with open(tmp_path / "mbb300_history.json") as f:
        assert json.load(f)["cg_passes_at_cap"] == [0, 0, 0]
    ref = rec["reference"]
    assert ref["quantity"] == "last step" and ref["ours"] == rec["last_step_compliance"]
    assert ref["rel"] == pytest.approx((ref["ours"] - 316.48) / 316.48)
    assert os.path.exists(tmp_path / "mbb300_densities.npy")


def test_longest_run():
    assert reproduce.longest_run([]) == 0
    assert reproduce.longest_run([False, True, True, False, True]) == 2
    assert reproduce.longest_run([True] * 6) == 6


@pytest.mark.parametrize("refined", [False, True], ids=["fp32", "refined"])
def test_cg_passes_at_cap_counts_capped_passes(refined):
    """A cap of one CG iteration stops every pass there: the count grows
    by one per pass; a cap the solve never reaches adds nothing."""
    prob, _ = problem_from_config(load_problem("problems/3d/cantilever_flexion.json"),
                                  dims=(8, 4, 4), dtype=torch.float32, device="cpu")
    cfg = tmg.build_mg_config(prob, 1)
    rho = torch.full((8, 4, 4), 0.4, dtype=torch.float32)
    counts = {}
    for cap in (1, 400):
        settings = tmg.MGSolverSettings(num_levels=1, cg_iter=cap, tol=1e-6,
                                        smoother="chebyshev", mixed_precision=refined)
        n0 = tmg.stats["cg_passes_at_cap"]
        _, iters = tmg.mgpcg_solve(cfg, prob, rho, None, settings)
        counts[cap] = (tmg.stats["cg_passes_at_cap"] - n0, iters)
    # one iteration per pass: the iterations count the passes (the refined
    # solve runs several, each from a new float64 residual)
    passes, iters = counts[1]
    assert passes == iters and (passes >= 2 if refined else passes == 1)
    assert counts[400][0] == 0 and 0 < counts[400][1] < 400


def test_steps_record_their_passes_at_cap():
    """Every step of an OC run and of a neural run capped at 2 CG
    iterations has a pass at the cap; the steps' counts sum to the loop's
    ``multigrid.stats`` count."""
    mbb = load_problem("problems/2d/mbb_beam.json")
    res = classic.ground_truth_topopt(mbb, dims=(24, 8), max_iter=3, multigrid_levels=1,
                                      cg_iter=2, tol=1e-6, device="cpu", log=lambda s: None)
    assert len(res.cg_passes_at_cap) == 3 and min(res.cg_passes_at_cap) > 0
    assert sum(res.cg_passes_at_cap) == res.solver_stats["cg_passes_at_cap"]
    assert reproduce.longest_run([n > 0 for n in res.cg_passes_at_cap]) == 3
    ncfg = neural.NeuralTOConfig(embedding_size=8, n_neurons=8, n_layers=2,
                                 volume_constraint_satisfier="constrained_sigmoid",
                                 multigrid_levels=1, cg_iter=2, cg_tol=1e-6)
    for scan in (0, 2):
        _, _, aux = neural.train(mbb, ncfg, dims=(16, 8), max_iter=2, log=lambda s: None,
                                 device="cpu", scan_chunk=scan)
        assert len(aux["cg_passes_at_cap"]) == 2 and min(aux["cg_passes_at_cap"]) > 0
        assert sum(aux["cg_passes_at_cap"]) == aux["solver_stats"]["cg_passes_at_cap"]


def test_mg_fields_match_jax():
    """The sweep's fields: numpy's default_rng(0) draws smoothed by each
    package's radius-2 filter (wider than the 4-cell axes)."""
    dims = (8, 4, 4)
    rng = np.random.default_rng(0)
    smoother = jflt.SmoothingFilter(radius=2)
    ref = [np.asarray(smoother.apply(jnp.asarray(
        np.where(rng.uniform(size=dims) < 0.5, 0.05, 1.0)))) for _ in range(3)]
    out = mg_benchmark.density_fields(dims, 3)
    for o, r in zip(out, ref):
        assert o.dtype == np.float64
        np.testing.assert_allclose(o, r, rtol=1e-12, atol=0)


def test_mg_sweep_on_cpu():
    """18 operating points in the JAX script's order; at each (Emin, warm)
    the compliance error falls with the CG tolerance."""
    rows = mg_benchmark.sweep((8, 4, 4), n_fields=2, levels=1, device="cpu")
    assert [(r["Emin"], r["tol"], r["warm"]) for r in rows] == [
        (e, t, w) for e in mg_benchmark.EMINS for t in mg_benchmark.TOLS
        for w in (False, True)]
    for e in mg_benchmark.EMINS:
        for w in (False, True):
            errs = [r["c_err_mean"] for r in rows if r["Emin"] == e and r["warm"] == w]
            assert errs[0] > errs[1] > errs[2], (e, w, errs)
    for r in rows:
        assert r["c_err_mean"] < 10 * r["tol"] and r["cg_iters_mean"] >= 1


def test_mg_table_renders_envelope_table(capsys):
    ref = subprocess.run([sys.executable, "scripts/envelope_table.py", ENVELOPE], cwd=ROOT,
                         capture_output=True, text=True, check=True, timeout=60).stdout
    mg_benchmark.main(["--table", ENVELOPE])
    assert capsys.readouterr().out == ref


def test_neural_throughput_configs():
    assert list(neural_throughput.CONFIGS) == ["cheb2_mgl2", "cheb2_mgl3", "cheb4_mgl3",
                                               "gs_mgl3", "gs_mgl2"]
    with pytest.raises(SystemExit):
        neural_throughput.main(["3", "cheb2_mgl9", "--device", "cpu"])


def test_neural_throughput_on_cpu():
    """The measurement loop at a small grid: one report window of 20
    steps, finite compliance, CG iterations in range."""
    lines = []
    res = neural_throughput.measure("cheb2_mgl2", 21, device="cpu", dims=(8, 4, 4),
                                    log=lines.append)
    (w,) = res["windows"]
    assert w["step"] == 20 and np.isfinite(w["compliance"]) and w["it_per_s"] > 0
    assert 1 <= w["cg_iters_mean"] < 100
    assert lines[0].startswith("[cheb2_mgl2] step   20: c=")
    assert lines[-1].startswith("[cheb2_mgl2] TOTAL 20 steps in ")


def test_validate_2d_two_ranks_on_cpu(capsys):
    """Unsharded, 2 slabs and 1x2 pencils at 16x8x8 (mgl=2: the pencils'
    local y extent, 4, takes two coarsenings), one OC step each."""
    out = validate_2d.main(["--dims", "16,8,8", "--steps", "1", "--ranks", "2",
                            "--mgl", "2", "--device", "cpu"])
    assert list(out["runs"]) == ["unsharded", "2", "1x2"]
    assert all(v < validate_2d.TOL for v in out["errors"].values()), out["errors"]
    assert capsys.readouterr().out.strip().endswith("OK")
