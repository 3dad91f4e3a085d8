"""The control, the reference put in the program's place one precision
down, comes out not correct under each configuration's limits; here at a
size the CPU holds (``benchmark/control.py`` reads it on the card at the
cells' own sizes)."""

import time

from benchmark import control
from benchmark.harness.program import Context
from benchmark.harness.spec import Spec
from benchmark.reference.precision import fp8_linear


def _setup(tiny, cell_name):
    spec = Spec(tiny)
    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    return spec, config, spec.traffic(cell["traffic"]), spec.driver(config["driver"])


def _fails(readings, limits):
    return any(readings[k] > v for k, v in limits.items())


def test_classic_control_is_not_correct(tiny):
    _, config, traffic, driver = _setup(tiny, "c3d256.fresh")
    _, ev = driver.run(Context(config, traffic, 77, 2.0, False, time.perf_counter(), "cpu"))
    got = control.classic_control(config, ev, "cpu")
    assert _fails(got, config["limits"]), got
    assert got["residual"] > config["limits"]["residual"]


def test_neural_control_is_not_correct(tiny):
    _, config, _, driver = _setup(tiny, "ns192.train")
    ref = driver.reference(config, 78, "cpu")
    ctl = driver.reference(config, 78, "cpu", linear=fp8_linear)
    got = driver.compare(driver.Observed.of_trajectory(ctl), ref)
    assert _fails(got, config["limits"]), got
