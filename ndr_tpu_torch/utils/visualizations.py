"""Plotting utilities (counterpart of ``ndr_tpu/utils/visualizations.py``):
loss curves, 2-D density renders, prediction-vs-ground-truth panels,
sigma-sweep grids and memory bar charts, with matplotlib alone.

Fields may be tensors on any device, or arrays. matplotlib is imported by
the functions that draw, with the Agg backend, not by this module: a
machine without matplotlib imports it, and a call there raises an
``ImportError`` that names matplotlib.
"""

from __future__ import annotations

import csv
import glob
import itertools
import os
import re
from typing import List, Optional, Sequence

import numpy as np


def _plt():
    """matplotlib's pyplot on the Agg backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("ndr_tpu_torch.utils.visualizations draws with matplotlib, "
                          "which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=float)


def _target_path(path: str, stem: str, ext: str = ".png") -> str:
    """Non-clobbering output path: append a counter when `stem` exists
    (the drivers re-run experiments under one jid)."""
    os.makedirs(path, exist_ok=True)
    for k in itertools.count():
        cand = os.path.join(path, (f"{stem}-{k}" if k else stem) + ext)
        if not os.path.exists(cand):
            return cand


def _finish(plt, fig, out: str) -> str:
    fig.savefig(out, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return os.path.splitext(os.path.basename(out))[0]


def loss_vis(compliance_loss_array, title, save=True, path="tmp/", ylim=None):
    """Compliance-vs-iteration curve. Returns the (possibly uniquified)
    file stem. (reference surface: visualizations.py:33-52)"""
    if not save:
        return title
    plt = _plt()
    ys = _host(compliance_loss_array).reshape(-1)
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(np.arange(ys.size), ys, lw=1.5)
    ax.set(xlabel="iteration", ylabel="compliance", title=title)
    if ylim is not None:
        ax.set_ylim(0.0, float(ylim))
    elif ys.size:
        # auto-scale to the steady tail; the first iterations of a TO run
        # are orders of magnitude above the converged value
        tail = ys[ys.size // 10:] if ys.size >= 10 else ys
        ax.set_ylim(0.0, float(np.max(tail)) * 1.2)
    ax.grid(True, alpha=0.3)
    return _finish(plt, fig, _target_path(path, title))


def _density_axes(ax, density) -> None:
    """Render one 2-D density field: solid material dark on light,
    x horizontal (fields are stored (nx, ny), C-order)."""
    ax.imshow(1.0 - _host(density).T, cmap="gray", origin="lower", vmin=0.0,
              vmax=1.0, interpolation="nearest")
    ax.set_axis_off()


def density_vis(density, loss, title, save=True, binary_loss=None, path="tmp/"):
    """2-D density image, compliance (and optional binary compliance) in
    the caption. (reference surface: visualizations.py:54-103)"""
    if not save:
        return title
    plt = _plt()
    nx, ny = _host(density).shape
    width = 9.0
    fig, ax = plt.subplots(figsize=(width, max(2.5, width * ny / nx)))
    _density_axes(ax, density)
    caption = f"{title} — compliance {float(loss):.4f}"
    if binary_loss is not None:
        caption += f" (binary {float(binary_loss):.4f})"
    ax.set_title(caption, fontsize=11)
    return _finish(plt, fig, _target_path(path, title))


def pred_gt_density_vis(pred, gt, pred_loss, gt_loss, title, save=True, path="tmp/"):
    """Stacked prediction / ground-truth density panels.
    (reference surface: visualizations.py:106-124)"""
    if not save:
        return title
    plt = _plt()
    panels = [("prediction", pred, pred_loss), ("ground truth", gt, gt_loss)]
    fig, axes = plt.subplots(len(panels), 1, figsize=(9, 7))
    for ax, (name, img, loss) in zip(np.atleast_1d(axes), panels):
        _density_axes(ax, img)
        ax.set_title(f"{name}: compliance {float(loss):.4f}", fontsize=11)
    fig.suptitle(title)
    return _finish(plt, fig, _target_path(path, title))


_SCALE_RE = re.compile(r"_s\[?([0-9.]+)\]?")


def _scale_key(path: str) -> float:
    """Sigma scale parsed from filenames like '..._s[2.5]_...' — the
    sweep drivers encode sigma in the jid. (reference surface:
    visualizations.py:137-150)"""
    m = _SCALE_RE.search(os.path.basename(path))
    return float(m.group(1)) if m else 0.0


def n_column_image_grid(title, image_list: Optional[List[str]] = None, path="tmp/",
                        patterns: Optional[Sequence[str]] = None, n_cols: int = 3):
    """Grid of saved density images sorted by their sigma scale.
    (reference surface: visualizations.py:127-177)"""
    if image_list is None:
        image_list = [p for pat in patterns or [] for p in glob.glob(pat)]
    image_list = sorted(image_list, key=_scale_key)
    if not image_list:
        return None
    plt = _plt()
    n_rows = -(-len(image_list) // n_cols)
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(5 * n_cols, 3.5 * n_rows),
                             squeeze=False)
    flat = axes.ravel()
    for ax in flat:
        ax.set_axis_off()
    for ax, img_path in zip(flat, image_list):
        ax.imshow(plt.imread(img_path))
        ax.set_title(os.path.basename(img_path), fontsize=8)
    fig.suptitle(title)
    out = os.path.join(path, title + "_grid.png")
    fig.savefig(out, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return out


def memory_usage_vis(csv_file, names=None):
    """Grouped bar chart of memory use per grid size from a CSV of
    `label, series1, series2, ...` rows. (reference surface:
    visualizations.py:20-30; pandas-free)"""
    names = names or ["Dimensions", "CPU-Mem", "GPU-Mem"]
    with open(csv_file) as fh:
        rows = [r for r in csv.reader(fh) if r]
    plt = _plt()
    labels = [r[0] for r in rows]
    series = list(zip(*[[float(v) for v in r[1:]] for r in rows]))
    fig, ax = plt.subplots(figsize=(max(6.0, 1.2 * len(labels)), 4))
    width = 0.8 / max(len(series), 1)
    xs = np.arange(len(labels))
    for i, vals in enumerate(series):
        label = names[i + 1] if i + 1 < len(names) else f"series{i}"
        ax.bar(xs + i * width, vals, width, label=label)
    ax.set_xticks(xs + width * (len(series) - 1) / 2, labels)
    ax.set(title="Memory Consumption", xlabel=names[0], ylabel="Memory (MB)")
    ax.legend()
    out = os.path.splitext(csv_file)[0] + ".jpg"
    fig.savefig(out)
    plt.close(fig)
    return out
