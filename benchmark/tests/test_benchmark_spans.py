"""The readers of the program's spans and counters, on records made by
hand: each reads what it should, and nothing (``None``) from a program
that keeps no such span or counter, as the parent of the change that
added them keeps none."""

import pytest

from benchmark.harness import spans
from benchmark.harness.spec import Spec

from conftest import REPO

COUNTERS = {"host_reads": 250, "oc.bisection_evals": 140, "mlp_forwards": 20,
            "oc.bisection.s": 0.05, "oc.bisection.self_s": 0.05, "oc.bisection.n": 10,
            "mg.hierarchy_build.s": 0.2, "mg.hierarchy_build.self_s": 0.2,
            "mg.hierarchy_build.n": 10, "mg.coarsest_factor.s": 0.03,
            "mg.coarsest_factor.self_s": 0.03, "mg.coarsest_factor.n": 10}


def _rec(window=COUNTERS, launched=(), device=(), host=(), steps=10, trace_steps=4):
    return {"counters": {"steps": steps, "stats_window": dict(window),
                         "stats_total": dict(window)},
            "trace": {"launched": list(launched), "device": list(device), "host": list(host),
                      "busy_s": sum(s for _, _, s in device), "steps": trace_steps,
                      "seconds": 1.0}}


LAUNCHED = [("aten::mm", ["mg.hierarchy_build", "solve", "oc.step"], 0.004),
            ("mg.hierarchy_build", ["solve", "oc.step"], 0.002),       # a ctypes launch
            ("aten::linalg_cholesky_ex", ["mg.coarsest_factor", "solve"], 0.008),
            ("aten::add", ["mg.cg", "solve"], 0.5)]


def _read(name, rec):
    return Spec(REPO).metric(name).read(rec)


@pytest.mark.parametrize("name,expected", [
    ("host_reads_per_step", 25.0),
    ("bisection_evals_per_step", 14.0),
    ("bisection_ms", 5.0),
    ("mlp_forwards_per_step", 2.0),
    ("hierarchy_build_ms", 1.5),        # (4 + 2) ms over 4 traced steps
    ("coarsest_factor_ms", 2.0),
])
def test_reader_reads_the_program_counter_or_span(name, expected):
    assert _read(name, _rec(launched=LAUNCHED)) == pytest.approx(expected)


@pytest.mark.parametrize("name", ["host_reads_per_step", "bisection_evals_per_step",
                                  "bisection_ms", "mlp_forwards_per_step",
                                  "hierarchy_build_ms", "coarsest_factor_ms"])
def test_reader_reads_nothing_where_the_program_has_no_span_or_counter(name):
    old = {"hierarchy_builds": 10, "cg_passes_at_cap": 0}
    old_launched = [("aten::mm", [], 0.004), ("aten::add", ["aten::matmul"], 0.5)]
    assert _read(name, _rec(window=old, launched=old_launched)) is None


def test_device_readers_read_nothing_from_an_untraced_run():
    rec = _rec(launched=LAUNCHED)
    rec["trace"] = None
    for name in ("hierarchy_build_ms", "coarsest_factor_ms"):
        assert _read(name, rec) is None


def test_span_names_are_those_with_times_and_calls():
    rec = _rec(window=dict(COUNTERS, **{"graph_capture_seconds": 0.1, "x.n": 3}))
    assert sorted(spans.span_names(rec)) == ["mg.coarsest_factor", "mg.hierarchy_build",
                                            "oc.bisection"]


def test_idle_is_put_down_to_the_innermost_open_span():
    """oc.step [0, 10] holds solve [1, 6] holds mg.cg [2, 4]; the device is
    busy over [0, 1.5], [3, 3.5] and [5, 9]."""
    host = [(0.0, 10.0, "oc.step"), (1.0, 6.0, "solve"), (2.0, 4.0, "mg.cg"),
            (2.5, 2.6, "aten::add")]
    device = [("k", 0.0, 1.5), ("k", 3.0, 0.5), ("k", 5.0, 4.0)]
    rec = _rec(device=device, host=host)
    idle, total = spans.idle_by_span(rec, ["oc.step", "solve", "mg.cg"])
    assert total == pytest.approx(3.0)
    assert idle == pytest.approx({"solve": 1.5, "mg.cg": 1.5})
    segs = spans.innermost(host, ["oc.step", "solve", "mg.cg"])
    assert segs == [(0.0, 1.0, "oc.step"), (1.0, 2.0, "solve"), (2.0, 4.0, "mg.cg"),
                    (4.0, 6.0, "solve"), (6.0, 10.0, "oc.step")]


def test_busy_under_spans_counts_each_kernel_once():
    rec = _rec(launched=LAUNCHED + [("aten::mul", ["aten::matmul"], 0.1)])
    got = spans.busy_under_spans(rec, ["oc.step", "solve", "mg.cg", "mg.hierarchy_build",
                                       "mg.coarsest_factor"])
    assert got == pytest.approx(0.514)
