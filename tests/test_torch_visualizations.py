"""The plots of ndr_tpu_torch (``utils/visualizations.py``): each writes
its image from CPU tensors (or arrays) as the JAX package's does, under
the same non-clobbering names; and without matplotlib the module still
imports and a call raises an ImportError naming it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ndr_tpu.utils import visualizations as jvis
from ndr_tpu_torch.utils import visualizations as vis


def _png(path):
    with open(path, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_loss_and_density_plots_write_pngs(tmp_path):
    out = str(tmp_path)
    losses = torch.linspace(100.0, 10.0, 30, dtype=torch.float64)
    assert vis.loss_vis(losses, "run", path=out) == "run"
    assert vis.loss_vis(losses.numpy(), "run", path=out, ylim=50) == "run-1"
    assert jvis.loss_vis(losses.numpy(), "run", path=out) == "run-2"   # the same names
    rho = torch.rand(24, 8, generator=torch.Generator().manual_seed(0))
    assert vis.density_vis(rho, torch.tensor(3.5), "dens", binary_loss=4.0,
                           path=out) == "dens"
    assert vis.pred_gt_density_vis(rho, 1 - rho, 1.0, 2.0, "pg", path=out) == "pg"
    for stem in ("run", "run-1", "dens", "pg"):
        assert _png(os.path.join(out, stem + ".png"))
    assert vis.loss_vis(losses, "skipped", save=False, path=out) == "skipped"
    assert not os.path.exists(os.path.join(out, "skipped.png"))


def test_image_grid_and_memory_chart(tmp_path):
    out = str(tmp_path)
    rho = torch.rand(12, 4, generator=torch.Generator().manual_seed(1))
    for s in (2.5, 0.5, 1.0):
        vis.density_vis(rho * s / 2.5, 1.0, f"sweep_s[{s}]", path=out)
    grid = vis.n_column_image_grid("sweep", patterns=[os.path.join(out, "sweep_s*.png")],
                                   path=out, n_cols=2)
    assert grid == os.path.join(out, "sweep_grid.png") and _png(grid)
    assert vis.n_column_image_grid("none", image_list=[], path=out) is None
    csv = tmp_path / "mem.csv"
    csv.write_text("64x32,10,20\n128x64,40,80\n")
    jpg = vis.memory_usage_vis(str(csv))
    assert jpg == str(tmp_path / "mem.jpg")
    with open(jpg, "rb") as f:
        assert f.read(2) == b"\xff\xd8"


def test_without_matplotlib_import_works_and_calls_raise():
    code = ("import sys; sys.modules['matplotlib'] = None; "
            "from ndr_tpu_torch.utils import visualizations as v\n"
            "try:\n    v.loss_vis([1.0, 2.0], 't', path='unused')\n"
            "except ImportError as e:\n    print('raised:', e)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "raised:" in proc.stdout and "matplotlib" in proc.stdout
    assert not os.path.exists(os.path.join(root, "unused"))


@pytest.mark.parametrize("as_tensor", [True, False])
def test_fields_come_to_the_host(tmp_path, as_tensor):
    rho = np.random.default_rng(2).uniform(size=(10, 5))
    field = torch.tensor(rho, requires_grad=True) if as_tensor else rho
    assert vis.density_vis(field, 1.0, "grad", path=str(tmp_path)) == "grad"
