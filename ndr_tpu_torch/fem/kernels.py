"""Hand-written CUDA stiffness kernels, their wrappers and plain twins
(counterpart of ``ndr_tpu/fem/pallas_kernels.py``).

One kernel for each Pallas kernel, plus the assembly of the cached
levels' node stencil; their sources are in ``ndr_tpu_torch/csrc/``:

=====================  ============================  ====================
wrapper                replaces (pallas_kernels.py)  source (csrc/)
=====================  ============================  ====================
apply_k_fine_f32       apply_k_pallas_flat           apply_k_fine_f32.cu
apply_k_fine_elem_f32  apply_k_pallas                apply_k_fine_elem_f32.cu
apply_k_cached_f32     apply_k_pallas_cached         cached_stencil.cu
cached_stencil         ke_stream_layout, the cached  cached_stencil.cu
                       kernel's operand layout
apply_k_fine_f64       apply_k_pallas_df             apply_k_fine.cu
apply_k_fine_elem_f64  apply_k_pallas_df_flat        apply_k_fine_elem.cu
=====================  ============================  ====================

Plain twins: :func:`apply_k_fine_plain` for the four fine wrappers,
:func:`apply_k_cached_f32_plain` and :func:`cached_stencil_plain`.
Both fp32 fine applies are element-centric in the basis of the element's
reflections (:func:`reflection_blocks`), streamed along x:
``apply_k_fine_f32`` recomputes the elements on its tiles' edges,
``apply_k_fine_elem_f32`` computes each element once and stitches the
forces on its blocks' faces in a second pass. The float64 one runs one
thread per node; the element-centric float64 one computes each element's
contraction once and sums per-offset partials in a second pass. A
cached (Galerkin) level is applied from its assembled node stencil
(:func:`cached_stencil`, built once per hierarchy build), not from its
per-element Ke stack. Which fine kernels the solver runs is its
``fine_kernel`` setting (:func:`fine_kernels`), the JAX package's
fine-kernel switch.

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
import itertools
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
_SOURCES = ("apply_k_fine_f32.cu", "apply_k_fine_elem_f32.cu", "apply_k_fine.cu",
            "apply_k_fine_elem.cu", "cached_stencil.cu")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Kernel launches per wrapper since the last :func:`reset_launches`.
launches: Dict[str, int] = {
    "apply_k_fine_f32": 0,
    "apply_k_fine_elem_f32": 0,
    "apply_k_cached_f32": 0,
    "cached_stencil": 0,
    "apply_k_fine_f64": 0,
    "apply_k_fine_elem_f64": 0,
}

_lib: Optional[ctypes.CDLL] = None
#: The K0 tensor (and its version) whose reflection blocks the fp32 fine
#: kernels' constant memory holds, per device index.
_fine_k0: Dict[int, Tuple[torch.Tensor, int]] = {}
#: apply_k_fine_elem_f32's block geometry (slab, tile y, tile z, partials
#: slots) per (device index, element dims), as its launcher picks it.
_elem_geometry: Dict[Tuple[int, Tuple[int, ...]], Tuple[int, int, int, int]] = {}
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
    lib.ndr_fine_set_blocks.argtypes = [ptr, i32, ptr]
    lib.ndr_fine_set_blocks.restype = i32
    lib.ndr_fine_elem_geometry.argtypes = [i32, i32, i32, i32, ctypes.POINTER(i32)]
    lib.ndr_fine_elem_geometry.restype = i32
    lib.ndr_apply_k_fine_elem_f32.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                              i32, i32, i32, ptr]
    lib.ndr_apply_k_fine_elem_f32.restype = i32
    lib.ndr_apply_k_fine_f32.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.ndr_apply_k_fine_f32.restype = i32
    lib.ndr_apply_k_fine_f64.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.ndr_apply_k_fine_f64.restype = i32
    lib.ndr_apply_k_fine_elem_f64.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                              i32, i32, ptr]
    lib.ndr_apply_k_fine_elem_f64.restype = i32
    lib.ndr_cached_stencil_f32.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr]
    lib.ndr_cached_stencil_f32.restype = i32
    lib.ndr_apply_k_cached_f32.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.ndr_apply_k_cached_f32.restype = i32
    lib.ndr_error_string.argtypes = [i32]
    lib.ndr_error_string.restype = ctypes.c_char_p
    _lib = lib
    _fine_k0.clear()
    _elem_geometry.clear()
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


#: Largest coefficient of K0 outside the reflection blocks, relative to
#: its largest, that :func:`reflection_blocks` accepts (fp32 rounding of a
#: symmetric K0 leaves 0; a float64 one ~1e-16).
REFLECTION_TOL = 1e-6


def reflection_blocks(K0: torch.Tensor, ndim: int) -> torch.Tensor:
    """K0 in the basis of the element's reflections, as the fp32 fine
    kernel takes it: (2^N, N, N) blocks B_s[c, d], divided by 2^N.

    With W the Walsh-Hadamard transform over the element's 2^N nodes
    applied to each component, ``W[(t, d), (b, d)] = (-1)^popcount(t & b)``,
    M = W K0 W^T / 2^N couples (t, c) with (t', d) only where
    t ^ e_c = t' ^ e_d (e_c the offset bit of axis c), and
    K0 u = W^T blockdiag(M) W u / 2^N. That holds when K0 is invariant
    under reflecting the element along each axis, as the stiffness of a box
    element with an isotropic material is; any other K0 raises."""
    npe = 1 << ndim
    sign = [[(-1.0) ** bin(t & b).count("1") for b in range(npe)] for t in range(npe)]
    Wn = torch.tensor(sign, dtype=torch.float64, device=K0.device)
    W = torch.kron(Wn, torch.eye(ndim, dtype=torch.float64, device=K0.device))
    M = W @ K0.double() @ W.t() / npe
    flip = [1 << (ndim - 1 - c) for c in range(ndim)]
    s = torch.arange(npe, device=K0.device)[:, None, None]
    rows = (s ^ torch.tensor(flip, device=K0.device)[None, :, None]) * ndim \
        + torch.arange(ndim, device=K0.device)[None, :, None]
    cols = (s ^ torch.tensor(flip, device=K0.device)[None, None, :]) * ndim \
        + torch.arange(ndim, device=K0.device)[None, None, :]
    B = M[rows, cols]                                  # (2^N, N, N)
    off = M.clone()
    off[rows, cols] = 0.0
    rel = float(off.abs().max() / M.abs().max())
    if rel > REFLECTION_TOL:
        raise ValueError(
            f"K0 is not invariant under the element's reflections (coupling "
            f"outside the reflection blocks {rel:.2e} of the largest > "
            f"{REFLECTION_TOL:g}): the fp32 fine kernel takes box elements of "
            f"an isotropic material")
    return (B / npe).to(torch.float32).contiguous()


def _set_fine_blocks(K0: torch.Tensor, grid: Grid) -> None:
    """Copy K0's reflection blocks into the constant memory of both fp32
    fine kernels unless this very tensor, unchanged since, is already
    there (once per problem, not per launch). Holding the tensor keeps its
    memory from being reused."""
    key = K0.device.index
    held = _fine_k0.get(key)
    if held is not None and held[0] is K0 and held[1] == K0._version:
        return
    B = reflection_blocks(K0, grid.ndim)
    code = _lib.ndr_fine_set_blocks(B.data_ptr(), grid.ndim, _stream(K0.device))
    _check_launch(code, "fp32 fine kernels (K0 blocks upload)")
    _fine_k0[key] = (K0, K0._version)


def apply_k_fine_f32(u: torch.Tensor, young: torch.Tensor, K0: torch.Tensor,
                     grid: Grid) -> torch.Tensor:
    """f = K(E) u in fp32 on a degree-1 grid; K0 is (d_pe, d_pe) fp32 and
    must be invariant under the element's reflections
    (:func:`reflection_blocks`)."""
    if not _on_cuda(u):
        return apply_k_fine_plain(u, young, K0, grid)
    _check_fine(u, young, K0, grid, torch.float32)
    lib = _library()
    f = torch.empty_like(u)
    with torch.cuda.device(u.device):
        _set_fine_blocks(K0, grid)
        code = lib.ndr_apply_k_fine_f32(u.data_ptr(), young.data_ptr(), f.data_ptr(),
                                        grid.ndim, *_dims3(grid), _stream(u.device))
    _check_launch(code, "apply_k_fine_f32")
    launches["apply_k_fine_f32"] += 1
    return f


def apply_k_fine_f64(u: torch.Tensor, young: torch.Tensor, K0: torch.Tensor,
                     grid: Grid) -> torch.Tensor:
    """f = K(E) u in float64 on a degree-1 grid; K0 is (d_pe, d_pe) f64.
    The refinement loop's true residual."""
    if not _on_cuda(u):
        return apply_k_fine_plain(u, young, K0, grid)
    _check_fine(u, young, K0, grid, torch.float64)
    lib = _library()
    f = torch.empty_like(u)
    with torch.cuda.device(u.device):
        code = lib.ndr_apply_k_fine_f64(u.data_ptr(), young.data_ptr(), K0.data_ptr(),
                                        f.data_ptr(), grid.ndim, *_dims3(grid),
                                        _stream(u.device))
    _check_launch(code, "apply_k_fine_f64")
    launches["apply_k_fine_f64"] += 1
    return f


# ---------------------------------------------------------------------------
# Element-centric fine-level apply, fp32 (replaces pallas_kernels.apply_k_pallas)
# and float64 (replaces pallas_kernels.apply_k_pallas_df_flat)
# ---------------------------------------------------------------------------

def elem_geometry(grid: Grid, device: torch.device) -> Tuple[int, int, int, int]:
    """:func:`apply_k_fine_elem_f32`'s block geometry on ``device`` (a
    card): (slab, tile y, tile z, partials slots). Blocks of slab x tile y
    x tile z elements (2-D: tile y x tile z over the grid's two axes) each
    keep one slot of N fp32 partial forces per node of their shell (their
    node box less its interior); only the slots of nodes on a block
    boundary inside the grid are written."""
    lib = _library()
    index = torch.device(device).index
    key = (torch.cuda.current_device() if index is None else index, tuple(grid.dims))
    if key not in _elem_geometry:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(key[0]):
            code = lib.ndr_fine_elem_geometry(grid.ndim, *_dims3(grid), out)
        _check_launch(code, "apply_k_fine_elem_f32 (geometry)")
        _elem_geometry[key] = tuple(out)
    return _elem_geometry[key]


def apply_k_fine_elem_f32(u: torch.Tensor, young: torch.Tensor, K0: torch.Tensor,
                          grid: Grid) -> torch.Tensor:
    """f = K(E) u in fp32 on a degree-1 grid, element-centric: each
    element's contraction once, in the reflection basis (K0 as for
    :func:`apply_k_fine_f32`), the forces on block faces stitched in a
    second pass."""
    if not _on_cuda(u):
        return apply_k_fine_plain(u, young, K0, grid)
    _check_fine(u, young, K0, grid, torch.float32)
    lib = _library()
    with torch.cuda.device(u.device):
        slab, ty, tz, slots = elem_geometry(grid, u.device)
        part = torch.empty((slots, grid.ndim), dtype=torch.float32, device=u.device)
        f = torch.empty_like(u)
        _set_fine_blocks(K0, grid)
        code = lib.ndr_apply_k_fine_elem_f32(
            u.data_ptr(), young.data_ptr(), part.data_ptr(), f.data_ptr(), grid.ndim,
            *_dims3(grid), slab, ty, tz, _stream(u.device))
    _check_launch(code, "apply_k_fine_elem_f32")
    launches["apply_k_fine_elem_f32"] += 1
    return f


#: x-elements per slab of the element-centric float64 kernel (one thread
#: walks a slab of one trailing element column), the TPU kernel's default.
ELEM_F64_SLAB = 8


def elem_f64_partials_shape(grid: Grid, slab: int = ELEM_F64_SLAB):
    """Shape of :func:`apply_k_fine_elem_f64`'s scratch: one partial force
    field per (x-slab, slab node plane, trailing node offset, component),
    over the trailing element dims."""
    nslabs = -(-grid.dims[0] // slab)
    return (nslabs, slab + 1, 1 << (grid.ndim - 1), grid.ndim) + tuple(grid.dims[1:])


def apply_k_fine_elem_f64(u: torch.Tensor, young: torch.Tensor, K0: torch.Tensor,
                          grid: Grid) -> torch.Tensor:
    """f = K(E) u in float64 on a degree-1 grid, element-centric: each
    element's contraction once, summed through per-offset partials (the
    refinement's true residual under ``fine_kernel="flat"``)."""
    if not _on_cuda(u):
        return apply_k_fine_plain(u, young, K0, grid)
    _check_fine(u, young, K0, grid, torch.float64)
    lib = _library()
    part = torch.empty(elem_f64_partials_shape(grid), dtype=torch.float64,
                       device=u.device)
    f = torch.empty_like(u)
    with torch.cuda.device(u.device):
        code = lib.ndr_apply_k_fine_elem_f64(
            u.data_ptr(), young.data_ptr(), K0.data_ptr(), part.data_ptr(),
            f.data_ptr(), grid.ndim, *_dims3(grid), ELEM_F64_SLAB, _stream(u.device))
    _check_launch(code, "apply_k_fine_elem_f64")
    launches["apply_k_fine_elem_f64"] += 1
    return f


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
# Cached-level apply from an assembled node stencil (replaces
# pallas_kernels.apply_k_pallas_cached and its ke_stream_layout)
# ---------------------------------------------------------------------------

def stencil_offsets(ndim: int):
    """The 3^N neighbour offsets of a node stencil, C order over
    (-1, 0, 1)^N."""
    return list(itertools.product((-1, 0, 1), repeat=ndim))


def stencil_shape(grid: Grid) -> Tuple[int, ...]:
    """(3^N, N, N) + node dims: slot (o, c, d) of node n is the coupling
    K[(n, c), (n + offset o, d)], slot-major so that neighbouring nodes
    of one slot lie at neighbouring addresses."""
    N = grid.ndim
    return (3 ** N, N, N) + grid.nodes_per_dim


def cached_stencil_plain(Ke: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Plain twin of :func:`cached_stencil`: the node stencil of the
    assembled K of a per-element stack ``Ke`` (dims + (d_pe, d_pe)), as
    slice adds of its N x N blocks, local node a outermost (the order in
    which the kernel sums each slot)."""
    N = grid.ndim
    offs = stencil_offsets(N)
    local = list(itertools.product((0, 1), repeat=N))
    S = Ke.new_zeros(stencil_shape(grid))
    for a, ab in enumerate(local):
        rows = tuple(slice(o, o + n) for o, n in zip(ab, grid.dims))
        for b, bb in enumerate(local):
            o = offs.index(tuple(y - x for x, y in zip(ab, bb)))
            block = Ke[..., a * N:(a + 1) * N, b * N:(b + 1) * N]
            S[(o, slice(None), slice(None)) + rows] += block.movedim((-2, -1), (0, 1))
    return S


def cached_stencil(Ke: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The node stencil (:func:`stencil_shape`, fp32) of a cached level
    from its per-element fp32 stack ``Ke`` (dims + (d_pe, d_pe))."""
    if not _on_cuda(Ke):
        return cached_stencil_plain(Ke, grid)
    _check_grid(grid)
    d_pe = grid.nodes_per_elem * grid.ndim
    _check("Ke", Ke, torch.float32, grid.dims + (d_pe, d_pe), Ke.device)
    if Ke.data_ptr() % 16:
        raise ValueError("Ke must be 16-byte aligned (the kernel reads float4)")
    lib = _library()
    S = torch.empty(stencil_shape(grid), dtype=torch.float32, device=Ke.device)
    with torch.cuda.device(Ke.device):
        code = lib.ndr_cached_stencil_f32(Ke.data_ptr(), S.data_ptr(), grid.ndim,
                                          *_dims3(grid), _stream(Ke.device))
    _check_launch(code, "cached_stencil")
    launches["cached_stencil"] += 1
    return S


def apply_k_cached_f32_plain(u, stencil, grid: Grid) -> torch.Tensor:
    """Plain twin of :func:`apply_k_cached_f32`: f[n] = sum over offsets
    o of S[o] u[n + o], u zero-padded by one node on every side."""
    N = grid.ndim
    up = torch.nn.functional.pad(u, (0, 0) + (1, 1) * N)
    f = torch.zeros_like(u)
    for o, off in enumerate(stencil_offsets(N)):
        nb = tuple(slice(1 + k, 1 + k + n) for k, n in zip(off, grid.nodes_per_dim))
        f += torch.einsum("cd...,...d->...c", stencil[o], up[nb])
    return f


def apply_k_cached_f32(u: torch.Tensor, stencil: torch.Tensor,
                       grid: Grid) -> torch.Tensor:
    """f = K u in fp32 from a cached level's node stencil
    (:func:`cached_stencil`)."""
    if not _on_cuda(u):
        return apply_k_cached_f32_plain(u, stencil, grid)
    _check_grid(grid)
    _check("u", u, torch.float32, grid.nodes_per_dim + (grid.ndim,), u.device)
    _check("stencil", stencil, torch.float32, stencil_shape(grid), u.device)
    lib = _library()
    f = torch.empty_like(u)
    with torch.cuda.device(u.device):
        code = lib.ndr_apply_k_cached_f32(
            u.data_ptr(), stencil.data_ptr(), f.data_ptr(),
            grid.ndim, *_dims3(grid), _stream(u.device))
    _check_launch(code, "apply_k_cached_f32")
    launches["apply_k_cached_f32"] += 1
    return f
