"""The command's refusals, and the plain reference's independence."""

import ast
import os
import shutil
import subprocess
import sys

from conftest import REPO


def _run(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_run_fails_with_no_line_where_it_finds_no_card():
    p = _run(REPO, "--workload", "c3d256.fresh", "--seed", "3000000001", "--seconds", "10",
             "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_run_fails_with_no_line_where_the_program_is_missing(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    code = ("import sys, time; sys.path.insert(0, '.');"
            "from benchmark import run;"
            "from benchmark.harness.spec import Spec;"
            "run.execute(Spec(), 'c3d256.fresh', 1, 1.0, False, time.perf_counter(), 'cpu')")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "ndr_tpu_torch" in p.stderr


def test_the_reference_imports_nothing_of_the_program_or_jax():
    for path in sorted((REPO / "benchmark" / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & {"ndr_tpu", "ndr_tpu_torch", "jax", "jaxlib", "flax"}, path
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.reference.fem, benchmark.reference.solve,"
            " benchmark.reference.classic, benchmark.reference.neural,"
            " benchmark.reference.precision;"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('ndr_tpu', 'ndr_tpu_torch', 'jax', 'jaxlib', 'flax')];"
            "print(bad); sys.exit(1 if bad else 0)")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
