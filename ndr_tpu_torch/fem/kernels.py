"""Hand-written CUDA stiffness kernels, their wrappers and plain twins
(counterpart of ``ndr_tpu/fem/pallas_kernels.py``).

Five kernels, one for each Pallas kernel; their sources are in
``ndr_tpu_torch/csrc/``. The node-centric fine applies are one templated
kernel in ``apply_k_fine.cu``, the element-centric ones another in
``apply_k_fine_elem.cu``:

=====================  ===========================  =========================
wrapper                replaces (pallas_kernels.py)  plain twin
=====================  ===========================  =========================
apply_k_fine_f32       apply_k_pallas_flat           apply_k_fine_plain (f32)
apply_k_fine_elem_f32  apply_k_pallas                apply_k_fine_plain (f32)
apply_k_cached_f32     apply_k_pallas_cached         apply_k_cached_f32_plain
                                                     on the stream layout
apply_k_fine_f64       apply_k_pallas_df             apply_k_fine_plain (f64)
apply_k_fine_elem_f64  apply_k_pallas_df_flat        apply_k_fine_plain (f64)
=====================  ===========================  =========================

Which fine kernels the solver runs is its ``fine_kernel`` setting
(:func:`fine_kernels`), the JAX package's fine-kernel switch.

A wrapper takes its twin only for tensors on the CPU. For a CUDA tensor
it launches its kernel or raises: there is no fallback. Each launch adds
one to the wrapper's entry in :data:`launches`, so a run can show that it
went through the kernels.

The kernels are built at first use (:func:`build`) with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``, under ``build/ndr_tpu_torch/`` in the checkout. The library's
name carries a hash of the sources and flags, so an edit rebuilds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

from ndr_tpu_torch.grid import Grid
from ndr_tpu_torch.fem import operators as ops

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ndr_tpu_torch"
_SOURCES = ("apply_k_fine.cu", "apply_k_fine_elem.cu", "apply_k_cached_f32.cu")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Kernel launches per wrapper since the last :func:`reset_launches`.
launches: Dict[str, int] = {
    "apply_k_fine_f32": 0,
    "apply_k_fine_elem_f32": 0,
    "apply_k_cached_f32": 0,
    "apply_k_fine_f64": 0,
    "apply_k_fine_elem_f64": 0,
}

_lib: Optional[ctypes.CDLL] = None
#: What the last :func:`build` did: library path, seconds, compiler output.
build_info: Dict[str, object] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def build() -> float:
    """Compile (if not yet built for these sources) and load the kernel
    library; returns the seconds it took. Raises if ``nvcc`` is missing
    or the build fails."""
    global _lib
    from torch.utils.cpp_extension import CUDA_HOME

    t0 = time.perf_counter()
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (no nvcc): cannot build "
                           "the ndr_tpu_torch kernels")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    sources = [str(_CSRC / s) for s in _SOURCES]
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for p in sorted(_CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib_path = _BUILD_DIR / f"libndr_kernels_{h.hexdigest()[:16]}.so"
    log = ""
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), *sources]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ndr_apply_k_fine_f32.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.ndr_apply_k_fine_f32.restype = i32
    lib.ndr_apply_k_fine_f64.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.ndr_apply_k_fine_f64.restype = i32
    for name in ("ndr_apply_k_fine_elem_f32", "ndr_apply_k_fine_elem_f64"):
        getattr(lib, name).argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                       i32, i32, ptr]
        getattr(lib, name).restype = i32
    lib.ndr_apply_k_cached_f32.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.ndr_apply_k_cached_f32.restype = i32
    lib.ndr_error_string.argtypes = [i32]
    lib.ndr_error_string.restype = ctypes.c_char_p
    _lib = lib
    seconds = time.perf_counter() - t0
    build_info.update(path=str(lib_path), seconds=seconds, log=log)
    return seconds


def _library() -> ctypes.CDLL:
    if _lib is None:
        build()
    return _lib


def _check_launch(code: int, name: str) -> None:
    if code != 0:
        msg = _lib.ndr_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_grid(grid: Grid) -> None:
    if grid.degree != 1 or grid.ndim not in (2, 3):
        raise NotImplementedError(
            "the CUDA stiffness kernels take degree-1 2-D/3-D grids")


def _dims3(grid: Grid):
    return tuple(grid.dims) + (1,) * (3 - grid.ndim)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no stiffness kernel for tensors on {t.device}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# Fine-level apply, fp32 (replaces pallas_kernels.apply_k_pallas_flat) and
# float64 (replaces pallas_kernels.apply_k_pallas_df)
# ---------------------------------------------------------------------------

def apply_k_fine_plain(u, young, K0, grid: Grid) -> torch.Tensor:
    """Plain twin of the four fine-level wrappers (fp32 and f64,
    node- and element-centric)."""
    return ops.apply_k(u, young, K0, grid)


def _check_fine(u, young, K0, grid: Grid, dtype: torch.dtype) -> None:
    _check_grid(grid)
    d_pe = grid.nodes_per_elem * grid.ndim
    _check("u", u, dtype, grid.nodes_per_dim + (grid.ndim,), u.device)
    _check("young", young, dtype, grid.dims, u.device)
    _check("K0", K0, dtype, (d_pe, d_pe), u.device)


def _apply_fine(u, young, K0, grid: Grid, dtype: torch.dtype,
                name: str) -> torch.Tensor:
    if not _on_cuda(u):
        return apply_k_fine_plain(u, young, K0, grid)
    _check_fine(u, young, K0, grid, dtype)
    entry = getattr(_library(), f"ndr_{name}")
    f = torch.empty_like(u)
    with torch.cuda.device(u.device):
        code = entry(u.data_ptr(), young.data_ptr(), K0.data_ptr(), f.data_ptr(),
                     grid.ndim, *_dims3(grid), _stream(u.device))
    _check_launch(code, name)
    launches[name] += 1
    return f


def apply_k_fine_f32(u: torch.Tensor, young: torch.Tensor, K0: torch.Tensor,
                     grid: Grid) -> torch.Tensor:
    """f = K(E) u in fp32 on a degree-1 grid; K0 is (d_pe, d_pe) fp32."""
    return _apply_fine(u, young, K0, grid, torch.float32, "apply_k_fine_f32")


def apply_k_fine_f64(u: torch.Tensor, young: torch.Tensor, K0: torch.Tensor,
                     grid: Grid) -> torch.Tensor:
    """f = K(E) u in float64 on a degree-1 grid; K0 is (d_pe, d_pe) f64.
    The refinement loop's true residual."""
    return _apply_fine(u, young, K0, grid, torch.float64, "apply_k_fine_f64")


# ---------------------------------------------------------------------------
# Element-centric fine-level apply, fp32 (replaces pallas_kernels.apply_k_pallas)
# and float64 (replaces pallas_kernels.apply_k_pallas_df_flat)
# ---------------------------------------------------------------------------

#: x-elements per slab of the element-centric kernels (one thread walks a
#: slab of one trailing element column), the TPU kernel's default slab.
ELEM_SLAB = 8


def elem_partials_shape(grid: Grid, slab: int = ELEM_SLAB):
    """Shape of the element-centric kernels' scratch: one partial force
    field per (x-slab, slab node plane, trailing node offset, component),
    over the trailing element dims."""
    nslabs = -(-grid.dims[0] // slab)
    return (nslabs, slab + 1, 1 << (grid.ndim - 1), grid.ndim) + tuple(grid.dims[1:])


def _apply_fine_elem(u, young, K0, grid: Grid, dtype: torch.dtype,
                     name: str) -> torch.Tensor:
    if not _on_cuda(u):
        return apply_k_fine_plain(u, young, K0, grid)
    _check_fine(u, young, K0, grid, dtype)
    entry = getattr(_library(), f"ndr_{name}")
    part = torch.empty(elem_partials_shape(grid), dtype=dtype, device=u.device)
    f = torch.empty_like(u)
    with torch.cuda.device(u.device):
        code = entry(u.data_ptr(), young.data_ptr(), K0.data_ptr(),
                     part.data_ptr(), f.data_ptr(), grid.ndim, *_dims3(grid),
                     ELEM_SLAB, _stream(u.device))
    _check_launch(code, name)
    launches[name] += 1
    return f


def apply_k_fine_elem_f32(u: torch.Tensor, young: torch.Tensor, K0: torch.Tensor,
                          grid: Grid) -> torch.Tensor:
    """f = K(E) u in fp32 on a degree-1 grid, element-centric: each
    element's contraction once, summed through per-offset partials."""
    return _apply_fine_elem(u, young, K0, grid, torch.float32,
                            "apply_k_fine_elem_f32")


def apply_k_fine_elem_f64(u: torch.Tensor, young: torch.Tensor, K0: torch.Tensor,
                          grid: Grid) -> torch.Tensor:
    """As :func:`apply_k_fine_elem_f32` in float64 (the refinement's true
    residual under ``fine_kernel="flat"``)."""
    return _apply_fine_elem(u, young, K0, grid, torch.float64,
                            "apply_k_fine_elem_f64")


#: The solver's ``fine_kernel`` settings: the JAX package's fine-kernel
#: switch (``pallas_kernels.apply_k_pallas_fine`` / ``_df_fine``).
FINE_KERNELS = ("flat32", "variant", "flat")


def fine_kernels(fine_kernel: str) -> Tuple[Callable, Callable]:
    """(fp32 fine apply, float64 residual apply) of a ``fine_kernel``
    setting, with the JAX package's dispatch:

    ==========  ======================  ======================
    setting     fp32 fine apply         float64 residual
    ==========  ======================  ======================
    flat32      apply_k_fine_f32        apply_k_fine_f64
    variant     apply_k_fine_elem_f32   apply_k_fine_f64
    flat        apply_k_fine_f32        apply_k_fine_elem_f64
    ==========  ======================  ======================
    """
    if fine_kernel not in FINE_KERNELS:
        raise ValueError(f"fine_kernel={fine_kernel!r}: one of {FINE_KERNELS}")
    f32 = apply_k_fine_elem_f32 if fine_kernel == "variant" else apply_k_fine_f32
    f64 = apply_k_fine_elem_f64 if fine_kernel == "flat" else apply_k_fine_f64
    return f32, f64


# ---------------------------------------------------------------------------
# Cached-Ke apply (replaces pallas_kernels.apply_k_pallas_cached)
# ---------------------------------------------------------------------------

def ke_stream_layout(Ke: torch.Tensor, grid: Grid) -> torch.Tensor:
    """(dims..., d_pe, d_pe) stack -> the coefficient-major stream layout
    (nx, d_pe^2, R), R = prod(dims[1:]) (``pallas_kernels.ke_stream_layout``)."""
    d_pe = grid.nodes_per_elem * grid.ndim
    R = grid.num_elements // grid.dims[0]
    ke = Ke.reshape(grid.dims[0], R, d_pe * d_pe)
    return ke.transpose(1, 2).contiguous()


def ke_from_stream(ke_stream: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Inverse of :func:`ke_stream_layout`."""
    d_pe = grid.nodes_per_elem * grid.ndim
    return ke_stream.transpose(1, 2).reshape(grid.dims + (d_pe, d_pe))


def apply_k_cached_f32_plain(u, ke_stream, grid: Grid) -> torch.Tensor:
    """Plain twin of :func:`apply_k_cached_f32`."""
    return ops.apply_k_cached(u, ke_from_stream(ke_stream, grid), grid)


def apply_k_cached_f32(u: torch.Tensor, ke_stream: torch.Tensor,
                       grid: Grid) -> torch.Tensor:
    """f = sum_e scatter(Ke_e gather_e(u)) in fp32 from a
    :func:`ke_stream_layout` stack."""
    if not _on_cuda(u):
        return apply_k_cached_f32_plain(u, ke_stream, grid)
    _check_grid(grid)
    d_pe = grid.nodes_per_elem * grid.ndim
    R = grid.num_elements // grid.dims[0]
    _check("u", u, torch.float32, grid.nodes_per_dim + (grid.ndim,), u.device)
    _check("ke_stream", ke_stream, torch.float32,
           (grid.dims[0], d_pe * d_pe, R), u.device)
    lib = _library()
    f = torch.empty_like(u)
    with torch.cuda.device(u.device):
        code = lib.ndr_apply_k_cached_f32(
            u.data_ptr(), ke_stream.data_ptr(), f.data_ptr(),
            grid.ndim, *_dims3(grid), _stream(u.device))
    _check_launch(code, "apply_k_cached_f32")
    launches["apply_k_cached_f32"] += 1
    return f
