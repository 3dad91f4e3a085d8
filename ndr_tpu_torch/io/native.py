"""ctypes bindings for the repo's native IO runtime, ``native/ndrio.cpp``
(counterpart of ``ndr_tpu/io/native.py``).

The library is built at first use with ``g++`` and the flags of
``native/Makefile`` into ``build/ndr_tpu_torch/`` in the checkout (git
ignores it), under a name that carries a hash of the source and flags, so
an edit rebuilds it. ``native/`` itself is never written: its tracked
``libndrio.so`` belongs to the JAX package. A failed build raises with the
compiler's message; there is no quiet fallback. The Python writers are
:mod:`ndr_tpu_torch.io.export`'s, which a caller takes by asking for them
(``use_native=False`` in :func:`write_msh`, :func:`write_vtr` and
:func:`load_ct`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ndr_tpu_torch.io import export
from ndr_tpu_torch.ops.resize import resize

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "ndrio.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ndr_tpu_torch"
# native/Makefile's CXXFLAGS and LDFLAGS
_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-lpthread")
_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile ``native/ndrio.cpp`` unless a library of this source and
    these flags is already built; returns its path. Raises with the
    compiler's output if ``g++`` fails."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    lib_path = _BUILD_DIR / f"libndrio_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS[:4], str(_SOURCE), "-o", str(tmp), *_FLAGS[4:]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build the native IO library: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: concurrent builders agree on the file
    return lib_path


def get_lib() -> ctypes.CDLL:
    """The loaded library (built first if needed)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    f64, i64 = np.ctypeslib.ndpointer(np.float64), np.ctypeslib.ndpointer(np.int64)
    lib.ndrio_write_msh.restype = ctypes.c_int
    lib.ndrio_write_msh.argtypes = [ctypes.c_char_p, ctypes.c_int, i64, f64, f64,
                                    ctypes.c_char_p, f64, ctypes.c_int64]
    lib.ndrio_read_msh_field.restype = ctypes.c_int64
    lib.ndrio_read_msh_field.argtypes = [ctypes.c_char_p, ctypes.c_char_p, f64,
                                         ctypes.c_int64]
    lib.ndrio_write_vtr.restype = ctypes.c_int
    lib.ndrio_write_vtr.argtypes = [ctypes.c_char_p, i64, f64, f64, ctypes.c_char_p,
                                    f64]
    lib.ndrio_load_ct_slices.restype = ctypes.c_int
    lib.ndrio_load_ct_slices.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
                                         ctypes.c_int64,
                                         np.ctypeslib.ndpointer(np.float32)]
    _lib = lib
    return _lib


def _host(field) -> np.ndarray:
    """A tensor (any device) or array as a contiguous float64 array."""
    if hasattr(field, "detach"):
        field = field.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(field, np.float64))


def write_msh(path: str, grid, field, name: str = "density",
              use_native: bool = True) -> str:
    """Gmsh export of one per-element field: binary, by the native
    library, or ASCII by :func:`export.write_msh` when ``use_native`` is
    False. Returns the path."""
    field = _host(field)
    if not use_native:
        return export.write_msh(path, grid, {name: field.reshape(grid.dims)})
    dims = np.zeros(3, np.int64)
    dims[:grid.ndim] = grid.dims
    origin = np.zeros(3)
    origin[:grid.ndim] = grid.domain_min
    spacing = np.ones(3)
    spacing[:grid.ndim] = grid.stretchings
    flat = field.reshape(-1)
    rc = get_lib().ndrio_write_msh(path.encode(), grid.ndim, dims, origin, spacing,
                                   name.encode(), flat, flat.size)
    if rc != 0:
        raise IOError(f"ndrio_write_msh failed with code {rc}")
    return path


def read_msh_field(path: str, name: str, num_elements: int) -> np.ndarray:
    """A per-element field of a Gmsh file (binary or ASCII)."""
    out = np.zeros(num_elements, np.float64)
    n = get_lib().ndrio_read_msh_field(path.encode(), name.encode(), out, out.size)
    if n < 0:
        raise IOError(f"ndrio_read_msh_field failed with code {n}")
    return out[:n]


def write_vtr(path: str, field, spacing=None, origin=None, name: str = "data",
              use_native: bool = True) -> str:
    """VTK RectilinearGrid of one cell field (2-D fields get a unit z),
    appended raw binary by the native library or base64 inline by
    :func:`export.write_vtr`. Returns the path written."""
    field = _host(field)
    if not use_native:
        return export.write_vtr(path, {name: field}, spacing=spacing, origin=origin)
    if field.ndim == 2:
        field = field[..., None]
    dims = np.asarray(field.shape, np.int64)
    spacing = np.asarray(spacing[:3] if spacing else (1.0, 1.0, 1.0), np.float64)
    origin = np.asarray(origin or (0.0, 0.0, 0.0), np.float64)
    if not path.endswith(".vtr"):
        path = path + ".vtr"
    rc = get_lib().ndrio_write_vtr(path.encode(), dims, origin, spacing, name.encode(),
                                   np.ascontiguousarray(field.reshape(-1)))
    if rc != 0:
        raise IOError(f"ndrio_write_vtr failed with code {rc}")
    return path


def load_ct(path: str, shape, interpolate_size=None,
            use_native: bool = True) -> np.ndarray:
    """A directory of 16-bit big-endian CT slices as a (h, w, n_slices)
    float32 volume scaled to [0, 1], optionally resized in-plane
    (trilinear, :func:`ndr_tpu_torch.ops.resize.resize`; reference:
    utils.load_ct, utils.py:379-406)."""
    files: List[str] = sorted(os.path.join(path, f) for f in os.listdir(path)
                              if os.path.isfile(os.path.join(path, f)))
    n = len(files)
    h, w = shape
    if use_native:
        out = np.zeros((n, h, w), np.float32)
        blob = b"\0".join(f.encode() for f in files) + b"\0"
        rc = get_lib().ndrio_load_ct_slices(blob, n, h, w, out)
        if rc != 0:
            raise IOError(f"ndrio_load_ct_slices failed with code {rc}")
        vol = np.transpose(out, (1, 2, 0))
    else:
        vol = np.stack([np.frombuffer(open(f, "rb").read(), dtype=">u2")
                        .reshape(shape).astype(np.float32) / 65535.0 for f in files],
                       axis=-1)
    if interpolate_size is not None:
        vol = resize(torch.from_numpy(np.ascontiguousarray(vol)),
                     (interpolate_size[0], interpolate_size[1], n), "linear").numpy()
    return np.clip(vol, 0.0, 1.0)
