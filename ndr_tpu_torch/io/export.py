"""Density / field export: .npy, VTK (.vtr), and Gmsh (.msh v2) (the
port's own copy of ``ndr_tpu/io/export.py``).

Replaces the reference's export paths (utils.py:302-376): 2-D densities
as transposed-negated .npy images, 3-D fields as meshes, and VTK
rectilinear grids for interactive ParaView visualization (the reference
uses pyevtk.gridToVTK; here a dependency-free writer emits the same .vtr
format). The Gmsh writer mirrors MSHFieldWriter usage for per-element
density fields on the voxel grid.
"""

from __future__ import annotations

import base64
import struct
from typing import Dict

import numpy as np


def save_densities_npy(density: np.ndarray, path: str):
    """2-D density image convention: negated transpose
    (reference: utils.py:302-313 save_densities)."""
    density = np.asarray(density)
    np.save(path, -density.T)


def write_vtr(path: str, cell_data: Dict[str, np.ndarray], spacing=None, origin=None):
    """Write a VTK XML RectilinearGrid (.vtr) with per-cell data.

    Produces the same file layout as pyevtk.hl.gridToVTK as used by the
    reference (utils.py:350-376): integer-coordinate axes of length
    dims+1, one CellData array per entry.
    """
    first = next(iter(cell_data.values()))
    dims = np.asarray(first).shape
    if len(dims) == 2:
        dims = dims + (1,)
        cell_data = {k: np.asarray(v)[..., None] for k, v in cell_data.items()}
    nx, ny, nz = dims
    spacing = spacing or (1.0, 1.0, 1.0)
    origin = origin or (0.0, 0.0, 0.0)
    axes = [
        origin[i] + spacing[i] * np.arange(dims[i] + 1, dtype=np.float64)
        for i in range(3)
    ]

    def b64(arr):
        raw = arr.tobytes()
        header = struct.pack("<I", len(raw))
        return base64.b64encode(header + raw).decode()

    if not path.endswith(".vtr"):
        path = path + ".vtr"
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write(
            '<VTKFile type="RectilinearGrid" version="1.0" '
            'byte_order="LittleEndian" header_type="UInt32">\n'
        )
        f.write(f'  <RectilinearGrid WholeExtent="0 {nx} 0 {ny} 0 {nz}">\n')
        f.write(f'    <Piece Extent="0 {nx} 0 {ny} 0 {nz}">\n')
        f.write("      <Coordinates>\n")
        for name, ax in zip("XYZ", axes):
            f.write(
                f'        <DataArray type="Float64" Name="{name}" '
                f'format="binary">{b64(ax)}</DataArray>\n'
            )
        f.write("      </Coordinates>\n")
        f.write("      <CellData>\n")
        for name, arr in cell_data.items():
            # VTK cell data is x-fastest; our arrays are C-order (x slowest)
            flat = np.asarray(arr, dtype=np.float64).transpose(2, 1, 0).ravel()
            f.write(
                f'        <DataArray type="Float64" Name="{name}" '
                f'format="binary">{b64(flat)}</DataArray>\n'
            )
        f.write("      </CellData>\n")
        f.write("    </Piece>\n  </RectilinearGrid>\n</VTKFile>\n")
    return path


def write_msh(path: str, grid, element_fields: Dict[str, np.ndarray]):
    """Write a Gmsh v2 ASCII mesh of the voxel grid with element fields.

    Mirrors the reference's MSHFieldWriter export of per-element density
    (utils.py:315-318): hexahedra in 3-D, quads in 2-D, Gmsh node
    ordering (counterclockwise faces — reference:
    TensorProductSimulator.hh:531-565 getMesh).
    """
    coords = grid.node_coordinates().reshape(-1, grid.ndim)
    if grid.ndim == 2:
        coords = np.concatenate([coords, np.zeros((len(coords), 1))], axis=1)

    from ndr_tpu_torch.fem.operators import element_node_flat_indices

    enodes = element_node_flat_indices(grid)  # (ne, 2^N) C-order corners
    if grid.ndim == 2:
        # C-order (00, 01, 10, 11) -> gmsh quad (00, 10, 11, 01)
        order = [0, 2, 3, 1]
        etype = 3
    else:
        # C-order (000,001,010,011,100,101,110,111) -> gmsh hexahedron
        # bottom face ccw then top face ccw:
        order = [0, 4, 6, 2, 1, 5, 7, 3]
        etype = 5
    conn = enodes[:, order]

    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write(f"$Nodes\n{len(coords)}\n")
        for i, p in enumerate(coords):
            f.write(f"{i+1} {p[0]:.17g} {p[1]:.17g} {p[2]:.17g}\n")
        f.write("$EndNodes\n")
        f.write(f"$Elements\n{len(conn)}\n")
        for e, nodes in enumerate(conn):
            node_str = " ".join(str(n + 1) for n in nodes)
            f.write(f"{e+1} {etype} 2 0 0 {node_str}\n")
        f.write("$EndElements\n")
        for name, field in element_fields.items():
            flat = np.asarray(field).ravel()
            f.write(f'$ElementData\n1\n"{name}"\n1\n0.0\n3\n0\n1\n{len(flat)}\n')
            for e, v in enumerate(flat):
                f.write(f"{e+1} {v:.17g}\n")
            f.write("$EndElementData\n")
    return path


def read_msh_element_field(path: str, name: str = "density") -> np.ndarray:
    """Read a per-element scalar field back from a Gmsh v2 file
    (reference: TPS::readDensities + MSHFieldParser)."""
    values = None
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        if lines[i].strip() == "$ElementData":
            n_tags = int(lines[i + 1])
            fname = lines[i + 2].strip().strip('"')
            # skip string tags, real tags, integer tags
            j = i + 1 + n_tags + 1
            n_real = int(lines[j])
            j += n_real + 1
            n_int = int(lines[j])
            ints = [int(lines[j + 1 + k]) for k in range(n_int)]
            j += n_int + 1
            count = ints[-1]
            if fname == name:
                vals = np.empty(count)
                for k in range(count):
                    idx, v = lines[j + k].split()
                    vals[int(idx) - 1] = float(v)
                return vals
            i = j + count
        else:
            i += 1
    raise KeyError(f"field {name!r} not found in {path}")
