"""What the drivers share in front of the program: the problem files it
reads, written from the configuration, and the run's context."""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path


@dataclasses.dataclass
class Context:
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    t0: float            # the process's start on the host clock
    device: str = "cuda"


def device_probes(device: str):
    """(synchronize, peak allocated bytes) of ``device``; on the CPU, which
    only the tests use, no-ops."""
    if device == "cpu":
        return (lambda: None), (lambda: 0)
    import torch

    return torch.cuda.synchronize, torch.cuda.max_memory_allocated


def write_problem(config: dict, directory: str) -> str:
    """The configuration's problem as the three JSON files of the reference
    format (problem, boundary conditions, material) in ``directory``;
    returns the problem file's path."""
    d = Path(directory)
    p = dict(config["problem"])
    bc, mat = p.pop("bc"), p.pop("material")
    (d / "problem.bc").write_text(json.dumps(bc))
    (d / "problem.material").write_text(json.dumps(mat))
    p["BC_PATH"] = os.fspath(d / "problem.bc")
    p["MATERIAL_PATH"] = os.fspath(d / "problem.material")
    p["gridDimensions"] = list(config["grid"])
    path = d / "problem.json"
    path.write_text(json.dumps(p))
    return os.fspath(path)
