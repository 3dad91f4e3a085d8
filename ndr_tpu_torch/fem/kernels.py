"""Hand-written CUDA stiffness kernels, their wrappers and plain twins
(counterpart of ``ndr_tpu/fem/pallas_kernels.py``).

One kernel for each Pallas kernel, plus the assembly of the cached
levels' node stencil; their sources are in ``ndr_tpu_torch/csrc/``:

=====================  ============================  ====================
wrapper                replaces (pallas_kernels.py)  source (csrc/)
=====================  ============================  ====================
apply_k_fine_f32       apply_k_pallas_flat           fine_stream.cu
apply_k_fine_f64       apply_k_pallas_df             fine_stream.cu
apply_k_fine_elem_f32  apply_k_pallas                fine_elem.cu
apply_k_fine_elem_f64  apply_k_pallas_df_flat        fine_elem.cu
apply_k_cached_f32     apply_k_pallas_cached         cached_stencil.cu
cached_stencil         ke_stream_layout, the cached  cached_stencil.cu
                       kernel's operand layout
apply_k_cached_bf16    apply_k_pallas_cached with a  cached_stencil.cu
                       bf16 Ke stream
cached_stencil_bf16    ke_stream_layout cast to      cached_stencil.cu
                       bf16
apply_k_cached_f64     apply_k_pallas_cached's       cached_stencil.cu
                       function in float64 (XLA's
                       apply_k_cached in JAX)
cached_stencil_f64     the float64 stencil assembly  cached_stencil.cu
=====================  ============================  ====================

Plain twins: :func:`apply_k_fine_plain` for the four fine wrappers,
:func:`apply_k_cached_f32_plain`, :func:`cached_stencil_plain`,
:func:`apply_k_cached_bf16_plain`, :func:`cached_stencil_bf16_plain`,
:func:`apply_k_cached_f64_plain` and :func:`cached_stencil_f64_plain`.
The bf16 pair stores the stencil in bf16 (the solver's
``cached_ke_dtype="bfloat16"``): the assembly sums in fp32 and rounds
each slot once, the apply widens each slot and sums in fp32. The float64
pair serves the cached levels of a float64 hierarchy: a float64 Ke stack,
stencil, u and f.
The four fine applies are two designs, each instantiated for fp32 and
for float64 (the refinement's true residual; Hopper has native FP64, so
no hi/lo split). Both are element-centric in the basis of the element's
reflections (:func:`reflection_blocks`), streamed along x:
``apply_k_fine_f32`` / ``_f64`` recompute the elements on their tiles'
edges, ``apply_k_fine_elem_f32`` / ``_f64`` compute each element once and
stitch the forces on their blocks' faces in a second pass. So all four
take only a K0 that is invariant under the element's reflections (a box
element of an isotropic material, every K0 this package builds) and raise
on any other; on every solver path the fp32 kernel already runs on the
same K0 before the float64 one. A cached (Galerkin) level is applied
from its assembled node stencil (:func:`cached_stencil`, built once per
hierarchy build), not from its per-element Ke stack. Which fine kernels
the solver runs is its ``fine_kernel`` setting (:func:`fine_kernels`),
the JAX package's fine-kernel switch.

A wrapper takes its twin only for tensors on the CPU. For a CUDA tensor
it launches its kernel or raises: there is no fallback. Each launch adds
one to the wrapper's entry in :data:`launches`, so a run can show that it
went through the kernels. Under CUDA-graph capture a wrapper records its
kernel without launching it; the graph's owner takes the capture's counts
back out and adds them again at every replay (:func:`add_launches`).

The kernels are built at first use (:func:`build`) with ``nvcc`` for
``sm_90a``, one compiler process per source, all started together, into
a shared library with a plain C interface, loaded with ``ctypes``, under
``build/ndr_tpu_torch/`` in the checkout. The library's name carries a
hash of the sources and flags, so an edit rebuilds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

from ndr_tpu_torch.grid import Grid
from ndr_tpu_torch.fem import operators as ops

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ndr_tpu_torch"
_SOURCES = ("fine_stream.cu", "fine_elem.cu", "cached_stencil.cu")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: Name suffix of the C entry points of each kernel type.
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: ... and of each storage type of the cached levels' stencil.
_STENCIL_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float64: "f64"}

#: Kernel launches per wrapper since the last :func:`reset_launches`.
launches: Dict[str, int] = {
    "apply_k_fine_f32": 0,
    "apply_k_fine_elem_f32": 0,
    "apply_k_cached_f32": 0,
    "cached_stencil": 0,
    "apply_k_fine_f64": 0,
    "apply_k_fine_elem_f64": 0,
    "apply_k_cached_bf16": 0,
    "cached_stencil_bf16": 0,
    "apply_k_cached_f64": 0,
    "cached_stencil_f64": 0,
}

_lib: Optional[ctypes.CDLL] = None
#: The K0 tensor (and its version) whose reflection blocks the fine
#: kernels' constant memory holds, per (device index, kernel dtype).
_fine_k0: Dict[Tuple[int, torch.dtype], Tuple[torch.Tensor, int]] = {}
#: The element-centric kernels' block geometry (slab, tile y, tile z,
#: partials slots) per (device index, element dims, dtype), as their
#: launcher picks it.
_elem_geometry: Dict[Tuple[int, Tuple[int, ...], torch.dtype],
                     Tuple[int, int, int, int]] = {}
#: What the last :func:`build` did: library path, seconds, and the compiler
#: output of the library's build (kept beside it, so also when it was cached).
build_info: Dict[str, object] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``counts`` to :data:`launches`: the kernels a CUDA
    graph launches per replay (negative ``times`` takes a capture's counts
    back out: a capture records kernels, it launches none)."""
    for name, n in counts.items():
        launches[name] += times * n


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
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for p in sorted(_CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib_path = _BUILD_DIR / f"libndr_kernels_{h.hexdigest()[:16]}.so"
    log_path = lib_path.with_suffix(".log")  # the compiler output of its build
    if lib_path.exists():
        log = log_path.read_text() if log_path.exists() else ""
    else:
        obj_dir = _BUILD_DIR / f"{lib_path.stem}.{os.getpid()}.obj"
        obj_dir.mkdir(parents=True, exist_ok=True)
        objs = [obj_dir / f"{Path(s).stem}.o" for s in _SOURCES]
        procs = [subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", "-o", str(o), str(_CSRC / s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for s, o in zip(_SOURCES, objs)]
        outs = [proc.communicate()[0] for proc in procs]
        log = "".join(outs)
        for proc, out in zip(procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(proc.args)}\n{out}")
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{' '.join(link.args)}\n{log}")
        shutil.rmtree(obj_dir, ignore_errors=True)
        log_path.write_text(log)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for sfx in _SUFFIX.values():
        getattr(lib, f"ndr_fine_set_blocks_{sfx}").argtypes = [ptr, i32, ptr]
        getattr(lib, f"ndr_fine_elem_geometry_{sfx}").argtypes = [
            i32, i32, i32, i32, ctypes.POINTER(i32)]
        getattr(lib, f"ndr_apply_k_fine_{sfx}").argtypes = [
            ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        getattr(lib, f"ndr_apply_k_fine_elem_{sfx}").argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr]
        for fn in ("fine_set_blocks", "fine_elem_geometry", "apply_k_fine",
                   "apply_k_fine_elem"):
            getattr(lib, f"ndr_{fn}_{sfx}").restype = i32
    for sfx in _STENCIL_SUFFIX.values():
        getattr(lib, f"ndr_cached_stencil_{sfx}").argtypes = [ptr, ptr, i32, i32, i32,
                                                              i32, ptr]
        getattr(lib, f"ndr_apply_k_cached_{sfx}").argtypes = [ptr, ptr, ptr, i32, i32,
                                                              i32, i32, ptr]
        getattr(lib, f"ndr_cached_stencil_{sfx}").restype = i32
        getattr(lib, f"ndr_apply_k_cached_{sfx}").restype = i32
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
# Fine-level apply in the reflection basis: streamed (replaces
# pallas_kernels.apply_k_pallas_flat in fp32 and apply_k_pallas_df in
# float64) and element-centric (replaces apply_k_pallas in fp32 and
# apply_k_pallas_df_flat in float64)
# ---------------------------------------------------------------------------

def apply_k_fine_plain(u, young, K0, grid: Grid) -> torch.Tensor:
    """Plain twin of the four fine-level wrappers (fp32 and f64,
    streamed and element-centric)."""
    return ops.apply_k(u, young, K0, grid)


def _check_fine(u, young, K0, grid: Grid, dtype: torch.dtype) -> None:
    _check_grid(grid)
    d_pe = grid.nodes_per_elem * grid.ndim
    _check("u", u, dtype, grid.nodes_per_dim + (grid.ndim,), u.device)
    _check("young", young, dtype, grid.dims, u.device)
    _check("K0", K0, dtype, (d_pe, d_pe), u.device)


#: Largest coefficient of K0 outside the reflection blocks, relative to
#: its largest, that :func:`reflection_blocks` accepts for the kernels of
#: each dtype: far below each type's own rounding of the apply (the
#: package's float64 K0s measure ~1e-16; their fp32 rounding leaves 0).
REFLECTION_TOL = {torch.float32: 1e-6, torch.float64: 1e-13}
_FINE_NAMES = {
    torch.float32: "fp32 fine kernels (apply_k_fine_f32, apply_k_fine_elem_f32)",
    torch.float64: "float64 fine kernels (apply_k_fine_f64, apply_k_fine_elem_f64)",
}


def reflection_blocks(K0: torch.Tensor, ndim: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K0 in the basis of the element's reflections, as the fine kernels
    of ``dtype`` (fp32 or float64) take it: (2^N, N, N) blocks B_s[c, d],
    divided by 2^N, computed in float64 and returned in ``dtype``.

    With W the Walsh-Hadamard transform over the element's 2^N nodes
    applied to each component, ``W[(t, d), (b, d)] = (-1)^popcount(t & b)``,
    M = W K0 W^T / 2^N couples (t, c) with (t', d) only where
    t ^ e_c = t' ^ e_d (e_c the offset bit of axis c), and
    K0 u = W^T blockdiag(M) W u / 2^N. That holds when K0 is invariant
    under reflecting the element along each axis, as the stiffness of a box
    element with an isotropic material is; a K0 whose coupling outside the
    blocks exceeds ``REFLECTION_TOL[dtype]`` of its largest raises."""
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
    if rel > REFLECTION_TOL[dtype]:
        raise ValueError(
            f"K0 is not invariant under the element's reflections (coupling "
            f"outside the reflection blocks {rel:.2e} of the largest > "
            f"{REFLECTION_TOL[dtype]:g}): the {_FINE_NAMES[dtype]} take box "
            f"elements of an isotropic material")
    return (B / npe).to(dtype).contiguous()


def _set_fine_blocks(K0: torch.Tensor, grid: Grid) -> None:
    """Copy K0's reflection blocks, in K0's dtype, into the constant memory
    of both fine kernels of that dtype unless this very tensor, unchanged
    since, is already there (once per problem, not per launch). Holding the
    tensor keeps its memory from being reused. Raises under CUDA-graph
    capture if an upload is needed."""
    key = (K0.device.index, K0.dtype)
    held = _fine_k0.get(key)
    if held is not None and held[0] is K0 and held[1] == K0._version:
        return
    if torch.cuda.is_current_stream_capturing():
        # the upload is a host-side copy that a graph would not replay
        raise RuntimeError(
            f"{_FINE_NAMES[K0.dtype]}: K0's reflection blocks must be uploaded "
            "before CUDA-graph capture (run the captured function once first)")
    B = reflection_blocks(K0, grid.ndim, K0.dtype)
    set_blocks = getattr(_lib, f"ndr_fine_set_blocks_{_SUFFIX[K0.dtype]}")
    code = set_blocks(B.data_ptr(), grid.ndim, _stream(K0.device))
    _check_launch(code, f"{_FINE_NAMES[K0.dtype]} (K0 blocks upload)")
    _fine_k0[key] = (K0, K0._version)


def upload_fine_blocks(K0: torch.Tensor, grid: Grid) -> None:
    """Make the fine kernels of K0's dtype read K0's reflection blocks (a
    no-op where they already do): before a CUDA graph that launches them is
    captured or replayed, since their constant memory is not the graph's."""
    _library()
    with torch.cuda.device(K0.device):
        _set_fine_blocks(K0, grid)


def _apply_fine(u, young, K0, grid: Grid, dtype: torch.dtype) -> torch.Tensor:
    name = f"apply_k_fine_{_SUFFIX[dtype]}"
    if not _on_cuda(u):
        return apply_k_fine_plain(u, young, K0, grid)
    _check_fine(u, young, K0, grid, dtype)
    lib = _library()
    f = torch.empty_like(u)
    with torch.cuda.device(u.device):
        _set_fine_blocks(K0, grid)
        code = getattr(lib, f"ndr_{name}")(u.data_ptr(), young.data_ptr(), f.data_ptr(),
                                           grid.ndim, *_dims3(grid), _stream(u.device))
    _check_launch(code, name)
    launches[name] += 1
    return f


def apply_k_fine_f32(u: torch.Tensor, young: torch.Tensor, K0: torch.Tensor,
                     grid: Grid) -> torch.Tensor:
    """f = K(E) u in fp32 on a degree-1 grid; K0 is (d_pe, d_pe) fp32 and
    must be invariant under the element's reflections
    (:func:`reflection_blocks`)."""
    return _apply_fine(u, young, K0, grid, torch.float32)


def apply_k_fine_f64(u: torch.Tensor, young: torch.Tensor, K0: torch.Tensor,
                     grid: Grid) -> torch.Tensor:
    """f = K(E) u in float64 on a degree-1 grid, the refinement loop's true
    residual; K0 is (d_pe, d_pe) float64 with the same symmetry, held to
    the float64 bound (:func:`reflection_blocks`)."""
    return _apply_fine(u, young, K0, grid, torch.float64)


def elem_geometry(grid: Grid, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> Tuple[int, int, int, int]:
    """The block geometry of the element-centric kernel of ``dtype`` on
    ``device`` (a card): (slab, tile y, tile z, partials slots). Blocks of
    slab x tile y x tile z elements (2-D: tile y x tile z over the grid's
    two axes) each keep one slot of N partial forces of ``dtype`` per node
    of their shell (their node box less its interior); only the slots of
    nodes on a block boundary inside the grid are written."""
    lib = _library()
    index = torch.device(device).index
    key = (torch.cuda.current_device() if index is None else index, tuple(grid.dims),
           dtype)
    if key not in _elem_geometry:
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(key[0]):
            code = getattr(lib, f"ndr_fine_elem_geometry_{_SUFFIX[dtype]}")(
                grid.ndim, *_dims3(grid), out)
        _check_launch(code, f"apply_k_fine_elem_{_SUFFIX[dtype]} (geometry)")
        _elem_geometry[key] = tuple(out)
    return _elem_geometry[key]


def _apply_fine_elem(u, young, K0, grid: Grid, dtype: torch.dtype) -> torch.Tensor:
    name = f"apply_k_fine_elem_{_SUFFIX[dtype]}"
    if not _on_cuda(u):
        return apply_k_fine_plain(u, young, K0, grid)
    _check_fine(u, young, K0, grid, dtype)
    lib = _library()
    with torch.cuda.device(u.device):
        slab, ty, tz, slots = elem_geometry(grid, u.device, dtype)
        part = torch.empty((slots, grid.ndim), dtype=dtype, device=u.device)
        f = torch.empty_like(u)
        _set_fine_blocks(K0, grid)
        code = getattr(lib, f"ndr_{name}")(
            u.data_ptr(), young.data_ptr(), part.data_ptr(), f.data_ptr(), grid.ndim,
            *_dims3(grid), slab, ty, tz, _stream(u.device))
    _check_launch(code, name)
    launches[name] += 1
    return f


def apply_k_fine_elem_f32(u: torch.Tensor, young: torch.Tensor, K0: torch.Tensor,
                          grid: Grid) -> torch.Tensor:
    """f = K(E) u in fp32 on a degree-1 grid, element-centric: each
    element's contraction once, in the reflection basis (K0 as for
    :func:`apply_k_fine_f32`), the forces on block faces stitched in a
    second pass."""
    return _apply_fine_elem(u, young, K0, grid, torch.float32)


def apply_k_fine_elem_f64(u: torch.Tensor, young: torch.Tensor, K0: torch.Tensor,
                          grid: Grid) -> torch.Tensor:
    """The float64 instance of :func:`apply_k_fine_elem_f32` (K0 as for
    :func:`apply_k_fine_f64`): the refinement's true residual under
    ``fine_kernel="flat"``."""
    return _apply_fine_elem(u, young, K0, grid, torch.float64)


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


def cached_stencil_bf16_plain(Ke: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Plain twin of :func:`cached_stencil_bf16`: the fp32 stencil, each
    slot rounded to bf16 once (to nearest even)."""
    return cached_stencil_plain(Ke, grid).to(torch.bfloat16)


#: Plain twin of :func:`cached_stencil_f64`: the dtype-generic
#: :func:`cached_stencil_plain` on a float64 stack, summed in float64.
cached_stencil_f64_plain = cached_stencil_plain


def _compute_dtype(stencil_dtype: torch.dtype) -> torch.dtype:
    """The type of Ke, u and f beside a stencil of ``stencil_dtype``."""
    return torch.float64 if stencil_dtype == torch.float64 else torch.float32


def _cached_stencil(Ke: torch.Tensor, grid: Grid, dtype: torch.dtype) -> torch.Tensor:
    sfx = _STENCIL_SUFFIX[dtype]
    name = "cached_stencil" if dtype == torch.float32 else f"cached_stencil_{sfx}"
    if not _on_cuda(Ke):
        return cached_stencil_plain(Ke, grid).to(dtype)
    _check_grid(grid)
    d_pe = grid.nodes_per_elem * grid.ndim
    _check("Ke", Ke, _compute_dtype(dtype), grid.dims + (d_pe, d_pe), Ke.device)
    if Ke.data_ptr() % 16:
        raise ValueError("Ke must be 16-byte aligned (the kernel reads 16-B vectors)")
    lib = _library()
    S = torch.empty(stencil_shape(grid), dtype=dtype, device=Ke.device)
    with torch.cuda.device(Ke.device):
        code = getattr(lib, f"ndr_cached_stencil_{sfx}")(
            Ke.data_ptr(), S.data_ptr(), grid.ndim, *_dims3(grid), _stream(Ke.device))
    _check_launch(code, name)
    launches[name] += 1
    return S


def cached_stencil(Ke: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The node stencil (:func:`stencil_shape`, fp32) of a cached level
    from its per-element fp32 stack ``Ke`` (dims + (d_pe, d_pe))."""
    return _cached_stencil(Ke, grid, torch.float32)


def cached_stencil_bf16(Ke: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The node stencil of :func:`cached_stencil`, stored in bf16: each
    slot summed in fp32 and rounded once."""
    return _cached_stencil(Ke, grid, torch.bfloat16)


def cached_stencil_f64(Ke: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The float64 node stencil of a cached level of a float64 hierarchy
    from its float64 stack ``Ke``, each slot summed in float64 in the
    twin's order."""
    return _cached_stencil(Ke, grid, torch.float64)


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


def apply_k_cached_bf16_plain(u, stencil, grid: Grid) -> torch.Tensor:
    """Plain twin of :func:`apply_k_cached_bf16`: the bf16 stencil widened
    to fp32, then :func:`apply_k_cached_f32_plain`."""
    return apply_k_cached_f32_plain(u, stencil.to(u.dtype), grid)


#: Plain twin of :func:`apply_k_cached_f64`: the dtype-generic
#: :func:`apply_k_cached_f32_plain` on float64 u and stencil.
apply_k_cached_f64_plain = apply_k_cached_f32_plain


def _apply_cached(u, stencil, grid: Grid, dtype: torch.dtype) -> torch.Tensor:
    sfx = _STENCIL_SUFFIX[dtype]
    name = f"apply_k_cached_{sfx}"
    if not _on_cuda(u):
        return apply_k_cached_f32_plain(u, stencil.to(u.dtype), grid)
    _check_grid(grid)
    _check("u", u, _compute_dtype(dtype), grid.nodes_per_dim + (grid.ndim,), u.device)
    _check("stencil", stencil, dtype, stencil_shape(grid), u.device)
    lib = _library()
    f = torch.empty_like(u)
    with torch.cuda.device(u.device):
        code = getattr(lib, f"ndr_{name}")(
            u.data_ptr(), stencil.data_ptr(), f.data_ptr(),
            grid.ndim, *_dims3(grid), _stream(u.device))
    _check_launch(code, name)
    launches[name] += 1
    return f


def apply_k_cached_f32(u: torch.Tensor, stencil: torch.Tensor,
                       grid: Grid) -> torch.Tensor:
    """f = K u in fp32 from a cached level's node stencil
    (:func:`cached_stencil`)."""
    return _apply_cached(u, stencil, grid, torch.float32)


def apply_k_cached_bf16(u: torch.Tensor, stencil: torch.Tensor,
                        grid: Grid) -> torch.Tensor:
    """f = K u in fp32 from a bf16 node stencil (:func:`cached_stencil_bf16`),
    each slot widened to fp32."""
    return _apply_cached(u, stencil, grid, torch.bfloat16)


def apply_k_cached_f64(u: torch.Tensor, stencil: torch.Tensor,
                       grid: Grid) -> torch.Tensor:
    """f = K u in float64 from a float64 node stencil
    (:func:`cached_stencil_f64`)."""
    return _apply_cached(u, stencil, grid, torch.float64)


_CACHED_APPLY = {torch.float32: apply_k_cached_f32, torch.bfloat16: apply_k_cached_bf16,
                 torch.float64: apply_k_cached_f64}


def apply_k_cached(u: torch.Tensor, stencil: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The cached apply of the stencil's storage type (fp32, bf16 or
    float64)."""
    return _CACHED_APPLY[stencil.dtype](u, stencil, grid)
