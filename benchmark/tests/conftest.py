"""A copy of the benchmark at a size the CPU runs in seconds: each
configuration's grid cut to 16x8x8 (and the network to 32 features,
16 x 3), warm-ups and traced stretches shortened. The harness, the
drivers, the reference and the limits are the benchmark's own."""

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIG = {
    "c3d256": lambda c: c["solver"].update(multigrid_levels=2),
    "ns192": lambda c: (c["network"].update(embedding_size=32, n_neurons=16, n_layers=3),
                        c["solver"].update(multigrid_levels=2)),
}


def make_tiny(root: Path) -> Path:
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, cut in TINY_CONFIG.items():
        p = root / "benchmark" / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c["grid"] = [16, 8, 8]
        cut(c)
        p.write_text(json.dumps(c))
    for p in (root / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t["warm_steps"] = 4
        t["trace_boundaries"] = min(t["trace_boundaries"], 2)
        if t.get("scan_chunk", 0) > 1:
            t["scan_chunk"] = 4
        p.write_text(json.dumps(t))
    return root


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    torch.set_num_threads(4)
    return make_tiny(tmp_path_factory.mktemp("tiny"))
