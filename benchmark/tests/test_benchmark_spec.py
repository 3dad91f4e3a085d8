"""The benchmark is found by name: every cell, configuration, traffic mix
and metric of BENCHMARK.json resolves to a file, and one added as files
alone is found with no edit."""

import json
import shutil

import pytest

from benchmark.harness import guard
from benchmark.harness.spec import Spec

from conftest import REPO


def test_every_entry_resolves_to_a_file():
    spec = Spec(REPO)
    data = spec.data
    for c in data["configs"]:
        cfg = spec.config(c["name"])
        assert (REPO / c["file"]).resolve() == (spec.dir / "configs" / f"{c['name']}.json")
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        spec.driver(cfg["driver"])
    for w in data["workloads"]:
        assert spec.cell(w["name"]) is w
        spec.config(w["config"])
        spec.traffic(w["traffic"])
    for kind in ("end_to_end", "per_layer"):
        for m in data[kind]:
            mod = spec.metric(m["name"])
            assert mod.UNIT == m["unit"], m["name"]
            assert callable(mod.read)
            if kind == "per_layer":
                assert mod.LAYER == m["layer"], m["name"]
                for w in m.get("workloads", []):
                    spec.cell(w)


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer_metric():
    spec = Spec(REPO)
    for w in spec.data["workloads"]:
        e2e = {m["name"] for m in spec.metrics("end_to_end", w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.metrics("per_layer", w["name"])
        assert layer
        assert all(m["moves"] in e2e for m in layer)


def test_a_cell_configuration_traffic_and_metric_added_as_files_are_found(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "benchmark" / "configs" / "c3d256.json").read_text())
    cfg["name"], cfg["grid"] = "c3d128", [128, 64, 64]
    (tmp_path / "benchmark" / "configs" / "c3d128.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark" / "traffic" / "slow.json").write_text(json.dumps(
        {"precond_lag": 0, "warm_steps": 8, "trace_boundaries": 4,
         "judge_start_steps": 3, "judge_window_sample": 2}))
    (tmp_path / "benchmark" / "metrics" / "steps_per_s.py").write_text(
        'UNIT = "steps/s"\nLAYER = "driver"\n\n\ndef read(rec):\n'
        '    return 1.0 / rec["window"]["step_s"]\n')
    data["configs"].append({"name": "c3d128", "source": "x", "file": "benchmark/configs/c3d128.json",
                            "reduced": ["grid"], "why": "x"})
    data["workloads"].append({"name": "c3d128.slow", "config": "c3d128", "traffic": "slow",
                              "chips": 1, "why": "x"})
    data["per_layer"].append({"name": "steps_per_s", "unit": "steps/s", "better": "higher",
                              "source": "host_clock", "layer": "driver", "moves": "step_ms",
                              "workloads": ["c3d128.slow"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    spec = Spec(tmp_path)
    assert spec.config(spec.cell("c3d128.slow")["config"])["grid"] == [128, 64, 64]
    assert spec.traffic("slow")["warm_steps"] == 8
    names = [m["name"] for m in spec.metrics("per_layer", "c3d128.slow")]
    assert "steps_per_s" in names and "mfu.neural" not in names
    assert "steps_per_s" not in [m["name"] for m in spec.metrics("per_layer", "c3d256.fresh")]
    assert spec.metric("steps_per_s").read({"window": {"step_s": 0.25}}) == 4.0


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax", True),
    ("ndr_tpu", True), ("ndr_tpu.fem.multigrid", True),
    ("ndr_tpu_torch", False), ("ndr_tpu_torch.fem.multigrid", False),
    ("jaxtyping", False), ("torch", False)])
def test_forbidden_modules_are_compared_by_whole_top_level_name(name, bad):
    assert guard.forbidden_loaded([name]) == ([name] if bad else [])
