"""The port's spans and counters (``ndr_tpu_torch/utils/timers.py``) on the
CPU: the counters against independent counts of the same work, the spans'
nesting on the host clock and in a ``torch.profiler`` trace, and the
operator's report of ``train_voxelfem``. Classic runs on the cantilever
at 16x8x8 with mgl 2, neural on the bridge at 16x8x8 with a tiny network.
"""

import json
import os

import pytest
import torch

from ndr_tpu_torch.fem import multigrid as mg
from ndr_tpu_torch.fem import topopt
from ndr_tpu_torch.fem.simulator import problem_from_config
from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.ops import filters as flt
from ndr_tpu_torch.ops import volume as vol
from ndr_tpu_torch.training import neural, train_voxelfem
from ndr_tpu_torch.training.classic import ground_truth_topopt
from ndr_tpu_torch.utils import timers

CANT = "problems/3d/cantilever_flexion.json"
BRIDGE = "problems/3d/bridge.json"
DIMS = (16, 8, 8)
STEPS = 3
OC_CHILDREN = ("oc.filter", "solve", "oc.adjoint", "oc.constraint_grad", "oc.bisection")
SOLVE_CHILDREN = ("mg.hierarchy_build", "mg.coarsest_factor", "mg.cg", "mg.residual64")


@pytest.fixture(scope="module")
def classic_run():
    """Three OC steps, the coarsest level factored by Cholesky, with every
    volume evaluation made without autograd (the bisection's; the constraint
    gradient's takes grad) counted apart."""
    evals = [0]
    total_volume_constraint = vol.total_volume_constraint

    def counted(rho, max_volume):
        evals[0] += not torch.is_grad_enabled()
        return total_volume_constraint(rho, max_volume)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vol, "total_volume_constraint", counted)
        res = ground_truth_topopt(load_problem(CANT), dims=DIMS, max_iter=STEPS,
                                  multigrid_levels=2, device="cpu", log=lambda s: None,
                                  solver_overrides={"coarse_solver": "cholesky"})
    return res, evals[0]


def test_registry_is_the_multigrid_stats_dict():
    assert mg.stats is timers.counters
    mg.reset_stats()
    assert mg.stats is timers.counters
    assert mg.stats["hierarchy_builds"] == 0 and mg.stats["graph_capture_seconds"] == 0.0


def test_cg_iters_counter_is_the_logged_sum(classic_run):
    res, _ = classic_run
    assert res.solver_stats["cg_iters"] == sum(res.cg_iters) > 0
    assert res.solver_stats["mg.cg.n"] >= STEPS


def test_bisection_evals_counter_is_an_independent_count(classic_run):
    res, evals = classic_run
    assert res.solver_stats["oc.bisection_evals"] == evals > STEPS


def test_host_reads_are_each_read_of_the_step(classic_run):
    """Per step: the refinement's ||b||, per CG pass its residual norm and
    one stop test more than its iterations, per build the count of pinned
    DOFs and the factorization's error code, the bisection's evaluations
    and the compliance."""
    st = classic_run[0].solver_stats
    expected = (STEPS * 2 + 2 * st["mg.cg.n"] + st["cg_iters"]
                + 2 * st["hierarchy_builds"] + st["oc.bisection_evals"])
    assert st["host_reads"] == expected


def test_span_self_time_and_nesting(classic_run):
    st = classic_run[0].solver_stats
    spans = timers.to_dict(st)
    for name, s in spans.items():
        assert 0.0 <= s["self_seconds"] <= s["seconds"], name
    for parent, children in (("oc.step", OC_CHILDREN), ("solve", SOLVE_CHILDREN)):
        inner = sum(spans[c]["seconds"] for c in children)
        assert spans[parent]["seconds"] >= inner
        assert spans[parent]["self_seconds"] + inner == pytest.approx(
            spans[parent]["seconds"], abs=1e-6)
    assert spans["oc.step"]["count"] == STEPS
    assert spans["OC optimization"]["seconds"] >= spans["oc.step"]["seconds"]


def test_span_as_decorator_nests_and_survives_an_exception():
    mg.reset_stats()

    @timers.span("test.outer")
    def outer(fail):
        with timers.span("test.inner"):
            if fail:
                raise ValueError("inside")

    outer(False)
    with pytest.raises(ValueError):
        outer(True)
    s = timers.to_dict()
    assert s["test.outer"]["count"] == 2 and s["test.inner"]["count"] == 2
    assert s["test.outer"]["seconds"] >= s["test.inner"]["seconds"]
    assert not timers._open


def test_spans_in_the_profiler_trace():
    """Under torch.profiler a span is a host event, the parent of the ops
    inside it, and none is a user annotation (one OC step at 8x4x4, its
    bisection stopped early to keep the trace short)."""
    cfg = load_problem(CANT)
    dims = (8, 4, 4)
    prob, _ = problem_from_config(cfg, dims=dims, dtype=torch.float32, device="cpu")
    settings = mg.MGSolverSettings(num_levels=1, cheb_degree=1, smoother="chebyshev")
    top = topopt.TopologyOptimizationProblem(
        prob=prob, filters=[flt.SmoothingFilter(radius=1), flt.ProjectionFilter(beta=1.0)],
        max_volume=cfg.max_volume, solve=mg.make_mg_solver(prob, settings))
    x = torch.full(dims, cfg.max_volume, dtype=torch.float32)
    state = topopt.oc_init(top, x, u_dtype=torch.float64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        topopt.oc_step(top, state, ctol=1e-2)
    events = list(prof.events())
    assert not any(e.is_user_annotation for e in events)

    def ancestors(e):
        out, p = [], e.cpu_parent
        while p is not None:
            out.append(p.name)
            p = p.cpu_parent
        return out

    by_name = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e)
    assert [e.cpu_parent.name for e in by_name["solve"]] == ["oc.step"]
    for name in OC_CHILDREN:
        assert by_name[name][0].cpu_parent.name == "oc.step", name
    bisection_ops = [e for e in events
                     if e.name.startswith("aten::") and "oc.bisection" in ancestors(e)]
    assert bisection_ops
    assert all("oc.step" in ancestors(e) for e in bisection_ops)


@pytest.mark.parametrize("scan_chunk,lag,from_step", [(2, 0, 4), (0, 0, 0), (0, 2, 2)],
                         ids=["scan_chunk", "host_loop", "host_loop_lag"])
def test_mlp_forwards_per_step(scan_chunk, lag, from_step):
    """One full-field forward a step on every path: under scan_chunk, and on
    the host loop with a lag, the step that is due a lagged preconditioner
    builds it from its own density; the host loop without lag builds none."""
    ncfg = neural.NeuralTOConfig(embedding_size=16, n_neurons=16, n_layers=2,
                                 multigrid_levels=2, use_kernels=False, precond_lag=lag)
    steps = 4
    _, _, aux = neural.train(load_problem(BRIDGE), ncfg, dims=DIMS, max_iter=steps,
                             device="cpu", log=lambda s: None, scan_chunk=scan_chunk)
    st = aux["solver_stats"]
    assert st["mlp_forwards"] == steps
    assert st["neural.step.n"] == steps
    assert st["neural.density.n"] == steps
    assert st["neural.precond_from_step"] == from_step
    assert st["neural.precond_build.n"] == from_step
    if from_step:
        assert st["neural.precond_from_step"] == st["hierarchy_builds"]
    assert st["cg_iters"] == sum(aux["cg_iters"])
    # per step: the solve's (the coarsest level takes the Newton-Schulz
    # inverse: no factorization's) and two of the step's metrics
    assert st["host_reads"] == (3 * steps + 2 * st["mg.cg.n"] + st["cg_iters"]
                                + st["hierarchy_builds"])


def test_precond_build_span_is_a_child_of_the_step():
    """Under torch.profiler the build of a step that is due one is a host
    event inside ``neural.step``, after the step's one ``neural.density``
    (a step at 4x2x2; each span's parent is read off the trace's raw events
    as the innermost one that holds it, on the span's thread)."""
    ncfg = neural.NeuralTOConfig(embedding_size=16, n_neurons=16, n_layers=2,
                                 multigrid_levels=1, use_kernels=False, cg_iter=4,
                                 volume_constraint_satisfier="maxed_barrier")
    state, train_step, _ = neural.build_trainer(load_problem(BRIDGE), ncfg, dims=(4, 2, 2),
                                                device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        state, metrics = train_step(state, rebuild=True)
    assert metrics["precond"] is not None
    raw = [(e.start_ns(), e.end_ns(), e.start_thread_id(), e.name())
           for e in prof.profiler.kineto_results.events()]

    def spans(name):
        return [e for e in raw if e[3] == name]

    def parent(e):
        outer = [o for o in raw if o is not e and o[2] == e[2]
                 and o[0] <= e[0] and e[1] <= o[1]]
        return min(outer, key=lambda o: o[1] - o[0])[3]

    assert [parent(e) for e in spans("neural.precond_build")] == ["neural.step"]
    assert [parent(e) for e in spans("neural.density")] == ["neural.step"]
    assert [parent(e) for e in spans("mg.precond_build")] == ["neural.precond_build"]
    assert spans("neural.density")[0][1] <= spans("neural.precond_build")[0][0]


def test_train_voxelfem_report_and_json(tmp_path, capsys):
    train_voxelfem.main(["--prob", "problems/2d/mbb_beam.json", "--grid", "[24,8]",
                         "--mgl", "1", "--iter", "2", "--device", "cpu",
                         "--out", str(tmp_path), "--jid", "tr"])
    with open(os.path.join(tmp_path, "tr_history.json")) as f:
        spans = json.load(f)["timers"]
    assert spans["OC optimization"]["count"] == 1
    assert spans["oc.step"]["count"] == 2
    assert spans["oc.step"]["seconds"] >= spans["oc.step"]["self_seconds"] > 0
    assert "oc.step: " in capsys.readouterr().err
