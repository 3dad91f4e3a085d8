"""Loaders for the reference-compatible JSON formats (the port's own copy
of ``ndr_tpu/io/problem.py``; NumPy only).

Three file kinds, byte-compatible with the reference so its bundled
problem suites work unchanged (SURVEY.md §5.6):

  * material JSON: ``{"type": "isotropic_material", "dim", "young",
    "poisson", ...}`` (reference: MeshFEM/Materials.hh; example
    VoxelFEM/examples/materials/B9Creator.material)
  * boundary-condition JSON: ``{"regions": [{"type": "dirichletxyz...",
    "value": [..], "box%": {"minCorner": [..], "maxCorner": [..]}}, ...]}``
    (reference: MeshFEM/BoundaryConditions.cc:278-378)
  * problem JSON: grid dims, domain corners, material/BC paths, SIMP
    parameters (reference: problems/2d/mbb_beam.json)

Semantics reproduced exactly:
  * ``box%`` corners are fractions of the domain bounding box
    (BoundaryConditions.cc: bbox.interpolatePoint); plain ``box`` corners
    are absolute coordinates.
  * ``dirichlet[xyz]*`` constrains only the listed components (all if no
    suffix) of every node whose coordinates fall inside the region
    (TensorProductSimulator.hh:391-406).
  * ``force`` distributes the total force vector *uniformly over the
    nodes in the region* (TensorProductSimulator.hh:371-385).
  * 3-D vectors in 2-D problems are truncated to their first two entries
    (BoundaryConditions.cc truncateFrom3D).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np

from ndr_tpu_torch.fem.element import IsotropicMaterial
from ndr_tpu_torch.grid import Grid, make_grid


# ---------------------------------------------------------------------------
# Material
# ---------------------------------------------------------------------------

def load_material(path: str, dim: int) -> IsotropicMaterial:
    with open(path) as f:
        data = json.load(f)
    if data.get("type") != "isotropic_material":
        raise ValueError(f"Unsupported material type {data.get('type')!r}")
    return IsotropicMaterial(
        young=float(data["young"]), poisson=float(data["poisson"]), dim=dim
    )


# ---------------------------------------------------------------------------
# Boundary conditions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Region:
    kind: str                    # "dirichlet" | "force"
    components: Tuple[int, ...]  # constrained components (dirichlet only)
    value: np.ndarray            # displacement / total force vector (N,)
    min_corner: np.ndarray       # absolute coordinates (N,)
    max_corner: np.ndarray

    def contains(self, pts: np.ndarray) -> np.ndarray:
        """Inclusive box membership for points of shape (..., N)."""
        return np.all(
            (pts >= self.min_corner) & (pts <= self.max_corner), axis=-1
        )


@dataclasses.dataclass(frozen=True)
class BoundaryConditions:
    """Evaluated nodal boundary conditions on a specific grid.

    Attributes:
      dirichlet_mask: bool, nodes_per_dim + (N,) — constrained components.
      dirichlet_values: float, nodes_per_dim + (N,) — imposed displacement
        (the solver currently supports zero values, like the reference's
        ``TPS::solve`` which rejects nonzero Dirichlet,
        TensorProductSimulator.hh:841).
      force: float, nodes_per_dim + (N,) — nodal force field ("load vector").
    """

    dirichlet_mask: np.ndarray
    dirichlet_values: np.ndarray
    force: np.ndarray


def _parse_component_suffix(suffix: str, ndim: int) -> Tuple[int, ...]:
    if not suffix:
        return tuple(range(ndim))
    comps = []
    for ch in suffix:
        c = "xyz".index(ch)
        if c < ndim:
            comps.append(c)
    return tuple(comps)


def _truncate(vec, ndim: int) -> np.ndarray:
    v = np.asarray([float(x) for x in vec], dtype=np.float64)
    return v[:ndim]


def parse_bc_regions(path: str, grid: Grid) -> List[_Region]:
    with open(path) as f:
        data = json.load(f)
    dom_min = np.asarray(grid.domain_min, dtype=np.float64)
    dom_size = grid.domain_size
    regions = []
    for cond in data["regions"]:
        ctype = cond["type"]
        if ctype.startswith("dirichlet"):
            kind = "dirichlet"
            comps = _parse_component_suffix(ctype[len("dirichlet"):], grid.ndim)
        elif ctype == "force":
            kind = "force"
            comps = ()
        else:
            raise ValueError(
                f"Unsupported BC type {ctype!r}; only dirichlet*/force accepted "
                "(matching TensorProductSimulator::applyDisplacementsAndLoads)"
            )
        if "box%" in cond:
            lo = dom_min + _truncate(cond["box%"]["minCorner"], grid.ndim) * dom_size
            hi = dom_min + _truncate(cond["box%"]["maxCorner"], grid.ndim) * dom_size
        elif "box" in cond:
            lo = _truncate(cond["box"]["minCorner"], grid.ndim)
            hi = _truncate(cond["box"]["maxCorner"], grid.ndim)
        else:
            raise ValueError("BC region must specify box or box%")
        regions.append(
            _Region(
                kind=kind,
                components=comps,
                value=_truncate(cond["value"], grid.ndim),
                min_corner=lo,
                max_corner=hi,
            )
        )
    return regions


def load_bcs(path: str, grid: Grid) -> BoundaryConditions:
    """Evaluate the BC file onto nodal mask/value/force fields."""
    regions = parse_bc_regions(path, grid)
    coords = grid.node_coordinates()            # nodes_per_dim + (N,)
    shape = coords.shape
    mask = np.zeros(shape, dtype=bool)
    values = np.zeros(shape, dtype=np.float64)
    force = np.zeros(shape, dtype=np.float64)

    for reg in regions:
        inside = reg.contains(coords)           # nodes_per_dim
        n_inside = int(inside.sum())
        if n_inside == 0:
            raise ValueError(
                f"BC region unmatched (no nodes inside): {reg}"
            )
        if reg.kind == "force":
            # total force split uniformly across region nodes
            force += inside[..., None] * (reg.value / n_inside)
        else:
            for c in reg.components:
                newly = inside & ~mask[..., c]
                conflict = inside & mask[..., c] & (
                    np.abs(values[..., c] - reg.value[c]) > 1e-10
                )
                if conflict.any():
                    raise ValueError("Conflicting dirichlet displacements.")
                mask[..., c] |= inside
                values[..., c] = np.where(newly, reg.value[c], values[..., c])

    return BoundaryConditions(dirichlet_mask=mask, dirichlet_values=values, force=force)


# ---------------------------------------------------------------------------
# Problem
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """Parsed problem JSON (reference: problems/2d/mbb_beam.json schema)."""

    name: str
    material_path: str
    bc_path: str
    order_fem: Tuple[int, ...]
    domain_corners: Tuple[Tuple[float, ...], Tuple[float, ...]]
    grid_dims: Tuple[int, ...]
    E0: float
    Emin: float
    simp_exponent: float
    max_volume: float
    seed: int
    adaptive_filtering: Optional[List[float]] = None

    def make_grid(self, dims=None) -> Grid:
        degree = self.order_fem[0]
        if any(d != degree for d in self.order_fem):
            raise ValueError("anisotropic FEM orders not supported")
        return make_grid(dims or self.grid_dims, self.domain_corners, degree=degree)


def load_problem(path: str, root: Optional[str] = None) -> ProblemConfig:
    """Load a problem JSON. Relative material/BC paths resolve against
    ``root`` (defaults to the directory containing bundled assets, then cwd).
    """
    with open(path) as f:
        cfg = json.load(f)

    def resolve(p):
        if os.path.isabs(p) or os.path.exists(p):
            return p
        for base in filter(None, [root, os.path.dirname(os.path.dirname(os.path.dirname(path))),
                                  os.getcwd()]):
            cand = os.path.join(base, p)
            if os.path.exists(cand):
                return cand
        return p

    mv = cfg["maxVolume"]
    if isinstance(mv, list):
        mv = mv[0]
    return ProblemConfig(
        name=cfg.get("problem_name", os.path.basename(path)),
        material_path=resolve(cfg["MATERIAL_PATH"]),
        bc_path=resolve(cfg["BC_PATH"]),
        order_fem=tuple(cfg["orderFEM"]),
        domain_corners=(tuple(cfg["domainCorners"][0]), tuple(cfg["domainCorners"][1])),
        grid_dims=tuple(cfg["gridDimensions"]),
        E0=float(cfg.get("E0", 1.0)),
        Emin=float(cfg.get("Emin", 1e-4)),
        simp_exponent=float(cfg.get("SIMPExponent", 3.0)),
        max_volume=float(mv),
        seed=int(cfg.get("seed", 0)),
        adaptive_filtering=cfg.get("adaptive_filtering"),
    )
