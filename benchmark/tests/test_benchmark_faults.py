"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card is skipped (the CPU at a small size), the rest
of the run is the benchmark's own. Faults a single-card TO step can have:
a step that returns its state unchanged, and an answer altered where it
is produced (the displacement; the compliance). A TO step has no batch of
independent rows to leave half out, and one card no exchange to skip."""

import dataclasses
import time

import pytest
import torch

from benchmark import run as brun
from benchmark.harness.spec import Spec


def _line(tiny, cell):
    return brun.execute(Spec(tiny), cell, 4242424242, 2.0, False, time.perf_counter(), "cpu")


def test_the_program_is_correct_here(tiny):
    for cell in ("c3d256.fresh", "ns192.train"):
        line = _line(tiny, cell)
        assert line["correct"], (cell, line["checks"])


@pytest.mark.parametrize("fault", ["state_unchanged", "displacement_altered"])
def test_classic_fault_is_not_correct(tiny, monkeypatch, fault):
    from ndr_tpu_torch.fem import topopt

    orig = topopt.oc_step

    def broken(top, state, **kw):
        new, metrics = orig(top, state, **kw)
        if fault == "state_unchanged":
            new = dataclasses.replace(new, x=state.x)
        else:
            new = dataclasses.replace(new, u=new.u * (1 + 1e-3))
        return new, metrics

    monkeypatch.setattr(topopt, "oc_step", broken)
    line = _line(tiny, "c3d256.fresh")
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "compliance_altered"])
def test_neural_fault_is_not_correct(tiny, monkeypatch, fault):
    from ndr_tpu_torch.fem import topopt

    if fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    else:
        orig = topopt.compliance_with_adjoint
        monkeypatch.setattr(topopt, "compliance_with_adjoint",
                            lambda rho, u, prob: orig(rho, u, prob) * (1 + 1e-2))
    line = _line(tiny, "ns192.train")
    assert not line["correct"], line["checks"]
