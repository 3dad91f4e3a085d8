"""Regular voxel-grid geometry and index conventions (the port's own copy
of ``ndr_tpu/grid.py``; NumPy only).

This replaces the reference's `NDVector<T>` + the grid/indexing half of
`TensorProductSimulator` (reference: VoxelFEM/NDVector.hh,
VoxelFEM/TensorProductSimulator.hh:252-316) with plain array-shape
conventions — the "ND vector" is just a tensor with a fixed axis order,
and all index maps are affine so they never materialize.

Conventions (used consistently across the whole package):

  * ``dims = (nx, ny[, nz])`` — elements per dimension.
  * element fields have shape ``dims`` and flatten in C order
    (last axis fastest), matching ``NDVector::flatIndex``
    (reference: VoxelFEM/NDVector.hh:280-303).
  * node fields have shape ``(nx*d+1, ny*d+1[, nz*d+1], N)`` for FEM
    degree ``d`` — C-order over the node grid with a trailing component
    axis, matching the reference's row-major ``VField`` over the node
    index (reference: VoxelFEM/TensorProductSimulator.hh:226).
  * element-local nodes are ordered C-style over the local multi-index
    (last dimension fastest), matching ``ElementNodeIndexer``
    (reference: VoxelFEM/TensorProductSimulator.hh:244-245).
  * element DOFs are node-major, component-minor: (x1, y1[, z1], x2, ...)
    (reference: VoxelFEM/TensorProductSimulator.hh:104-105).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static description of a regular tensor-product voxel grid.

    All members are Python/numpy values; nothing here is a tensor.
    Mirrors the geometric state of the reference
    ``TensorProductSimulator`` constructor
    (reference: VoxelFEM/TensorProductSimulator.hh:252-316).
    """

    dims: Tuple[int, ...]                # elements per dimension
    domain_min: Tuple[float, ...]        # bounding-box min corner
    domain_max: Tuple[float, ...]        # bounding-box max corner
    degree: int = 1                      # Lagrange degree (same in all dims)

    def __post_init__(self):
        if len(self.dims) not in (2, 3):
            raise ValueError(f"Only 2-D/3-D grids supported, got dims={self.dims}")
        if len(self.domain_min) != len(self.dims) or len(self.domain_max) != len(self.dims):
            raise ValueError("domain corners must match grid dimensionality")
        if self.degree < 1:
            raise ValueError("degree must be >= 1")

    # ---- basic sizes -------------------------------------------------------

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def num_elements(self) -> int:
        return int(np.prod(self.dims))

    @property
    def nodes_per_dim(self) -> Tuple[int, ...]:
        # elems * degree + 1 nodes along each dimension
        # (reference: TensorProductSimulator.hh:267 m_NbNodesPerDimension)
        return tuple(n * self.degree + 1 for n in self.dims)

    @property
    def num_nodes(self) -> int:
        return int(np.prod(self.nodes_per_dim))

    @property
    def nodes_per_elem_per_dim(self) -> Tuple[int, ...]:
        return tuple(self.degree + 1 for _ in self.dims)

    @property
    def nodes_per_elem(self) -> int:
        return int(np.prod(self.nodes_per_elem_per_dim))

    @property
    def dofs_per_elem(self) -> int:
        return self.ndim * self.nodes_per_elem

    # ---- geometry ----------------------------------------------------------

    @property
    def domain_size(self) -> np.ndarray:
        return np.asarray(self.domain_max, dtype=np.float64) - np.asarray(
            self.domain_min, dtype=np.float64
        )

    @property
    def stretchings(self) -> np.ndarray:
        """Per-dimension element edge length (uniform grid).

        (reference: TensorProductSimulator.hh:279-281 setStretchings)
        """
        return self.domain_size / np.asarray(self.dims, dtype=np.float64)

    @property
    def node_spacings(self) -> np.ndarray:
        return self.domain_size / (np.asarray(self.nodes_per_dim, dtype=np.float64) - 1.0)

    @property
    def element_volume(self) -> float:
        return float(np.prod(self.stretchings))

    @property
    def volume(self) -> float:
        return float(np.prod(self.domain_size))

    def node_coordinates(self) -> np.ndarray:
        """Coordinates of every node, shape ``nodes_per_dim + (ndim,)``.

        (reference: TensorProductSimulator.hh:271-277)
        """
        axes = [
            np.linspace(lo, hi, n, dtype=np.float64)
            for lo, hi, n in zip(self.domain_min, self.domain_max, self.nodes_per_dim)
        ]
        mesh = np.meshgrid(*axes, indexing="ij")
        return np.stack(mesh, axis=-1)

    # ---- refinement / coarsening ------------------------------------------

    def coarsened(self) -> "Grid":
        """Grid with every dimension halved (multigrid coarsening).

        (reference: MultigridSolver.hh:33-40 — grid must be divisible by 2)
        """
        if any(n % 2 for n in self.dims):
            raise ValueError(
                f"Grid dims {self.dims} not divisible by 2; cannot coarsen"
            )
        return dataclasses.replace(self, dims=tuple(n // 2 for n in self.dims))

    def with_dims(self, dims: Tuple[int, ...]) -> "Grid":
        return dataclasses.replace(self, dims=tuple(int(d) for d in dims))


def make_grid(dims, domain_corners=None, degree: int = 1) -> Grid:
    """Build a :class:`Grid` from a problem-JSON style description.

    ``domain_corners`` is ``[[min...], [max...]]`` as in the problem JSON
    files; defaults to the unit-stretch box ``[0, dims]`` like the
    reference's convenience constructor
    (reference: TensorProductSimulator.hh:319-323).
    """
    dims = tuple(int(d) for d in dims)
    if domain_corners is None:
        domain_min = tuple(0.0 for _ in dims)
        domain_max = tuple(float(d) for d in dims)
    else:
        domain_min = tuple(float(x) for x in domain_corners[0])
        domain_max = tuple(float(x) for x in domain_corners[1])
    return Grid(dims=dims, domain_min=domain_min, domain_max=domain_max, degree=degree)
