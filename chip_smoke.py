"""Smoke run of ndr_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``ndr_tpu_torch/csrc/`` (one
for each Pallas kernel, the cached levels' stencil assembly, and the
bf16 and float64 instances of the cached pair), holds
each against its plain PyTorch twin on the card (at the test shapes and
at the shapes the paths below give it; the stencil assembly bitwise) and
times each where the paths launch it, at 192x96x96 and at the bench grid
64x32x16 (the cached kernels: the Galerkin levels of those grids), beside
its bound, its twin and one library call (cuSPARSE CSR SpMV on the
assembled K). Then it drives the port's paths through their CLIs,
each with the launch counters set to 0 just before and read just after:

  1. classic SIMP-OC (``train_voxelfem``), cantilever 192x96x96, mgl=3,
     kernels on and off;
  2. neural TO (``train_xdg``), the north star: bridge 192x96x96, mgl=3,
     constrained_sigmoid, the 1024/512x4 MLP, with ``--fine-kernel
     variant`` and with the default ``flat32``;
  3. neural TO, the bench configuration: bridge 64x32x16, mgl=2,
     maxed_barrier, 1024/512x4, ``--fine-kernel flat``, and kernels off;
  4. classic SIMP-OC with the multicolor Gauss-Seidel smoother
     (``--smoother gs``), cantilever 192x96x96, mgl=3, kernels on and off,
     held to path 1's Chebyshev run at step 0;
  5. the mesh-independence evaluation (``eval_fourfeat``) of path 3's
     trained network at 128x64x32 (mgl=3) and 256x128x64 (mgl=4), 2x and
     4x its training grid;
  6. ``eval_voxelfem`` on path 4's final density upsampled to the
     cantilever's production grid 256x128x128 (mgl=5);
  7. the production classic configuration: cantilever 256x128x128, mgl=5,
     Chebyshev, 32 OC steps from the design of 20 fresh ones (the JAX
     package's lag measurement starts after 20 warm-up steps: from the
     uniform start a lagged hierarchy stalls CG after the first large OC
     moves, in both packages), (a) rebuilding every step, (b) with
     ``--precond-lag 8`` and (c) with ``--precond-lag 8 --scan 32`` (the
     chunked loop, its preconditioner replayed from a CUDA graph), (b) and
     (c) held to (a);
  8. classic GS 192x96x96 mgl=3 with ``--precond-lag 4 --scan 4`` from the
     design of 20 fresh Chebyshev steps, held to the host-loop GS run from
     the same design;
  9. neural TO, the bench configuration of path 3 with ``--precond-lag 4
     --scan 8``, held to path 3's run;
 10. the solver settings ``cached_ke_dtype="bfloat16"`` (the bf16 stencil
     kernels) and ``lmax_power_iters=8`` through ``make_mg_solver`` at
     192x96x96 mgl=3, each held to the fp32 bound-only solve;
 11. classic SIMP-OC in float64 (``--x64``), cantilever 192x96x96, mgl=3,
     kernels on (the float64 fine kernel and float64 stencils) and off, held
     to each other at step 0 (1e-10) and to path 1's fp32-refined run;
 12. the reference's 2-D MBB 300x100 log in float64: ``--x64 --smoother gs``
     mgl=2 with the kernels, 9 OC steps held to its objectives
     (``REFERENCE_TRACE``, rtol 2e-4); path 7's warm-up is held to the
     reference's cantilever 256x128x128 log (``C1001_HEAD``, rtol 3e-3);
 13. neural TO in float64, the bench configuration of path 3 with ``--x64``
     (the float64 element kernel as the CG operator);
 14. ``--optim LBFGS`` (augmented-Lagrangian projected L-BFGS), cantilever
     192x96x96, mgl=3, 20 inner iterations: finite, decreasing, feasible;
 15. a degree-2 grid (cantilever 32x16x16, orderFEM [2, 2, 2]), whose
     block-Jacobi PCG takes the plain applies (every kernel counter 0), and
     the Langelaar filter at 192x96x96 in float64 on the card against the
     same call on the CPU;
 16. periodic homogenization in float64 (``fem.homogenization``, the six
     cell problems in one batched block-Jacobi CG whose periodic apply
     launches ``apply_k_fine_f64`` once per cell problem): the periodic
     apply through both fine kernels against their twins at 64^3; a
     laminate at 64^3 held to its closed-form (Backus) tensor; a random
     cell at 32^3 card against CPU and its tensor gradient against a
     centred finite difference; a random cell at 64^3 timed;
 17. ``design_microstructure`` at 64^3: 10 Adam steps toward the
     laminate's tensor;
 18. the continual-learning trainer (``train_cl``) through its CLI at the
     north star's width: bridge 192x96x96, mgl=3, 1024/512x4, two tasks of
     4 steps with gated activations and forgetting, kernels on, then one
     step kernels off, held together at step 0;
 19. the model zoo (SIREN 256x3 on a 192x96 grid, the CNN and deconv
     generators at their default configs) in float64, forward and backward
     on the card against the CPU;
 20. the native IO library (``io/native.py``, built from
     ``native/ndrio.cpp``): path 1's density through .msh and .vtr and
     back, exactly, and equal to the Python writer's .vtr;
 21. the sharded classic path (``ground_truth_topopt(shards=...)``),
     cantilever 192x96x96, mgl=3, 5 OC steps, as 2 slabs (96x96x96 each)
     and as 2x2 pencils (96x48x96), 2 and 4 ranks sharing the card over
     gloo with host-staged halos: every rank launches both fine kernels on
     its local grid, and step 0 agrees with path 1's unsharded run to 1e-4
     (the local shapes' kernels are also checked and timed in the kernel
     phase, beside cuSPARSE CSR);
 22. ``make_sharded_solver`` on one rank over NCCL against the unsharded
     MGPCG at 192x96x96, both refined to 1e-8 (1e-6);
 23. ``dryrun_multichip(2)`` (a neural step over 2 slabs, a classic OC step
     over slabs and 1x2 pencils), 2 ranks sharing the card over gloo;
 24. ``parallel.dryrun.entry()``, the single-card forward step (MLP ->
     constrained sigmoid -> one MGPCG solve -> compliance) at 16x8x8, on
     the card against the same call on the CPU, and its gradient;
 25. ``utils.timers.trace``: a trace of that forward step holds device
     kernels;
 26. ``ops.volume.total_volume_constraint_grad`` and
     ``multigrid.build_level_stiffness`` (192x96x96, mgl=3, float64) on the
     card against the CPU;
 27. ``utils.reproduce --only mbb300,c3d_256 --iter 20``: the reference's
     2-D MBB 300x100 and cantilever 256x128x128 (mgl=5) runs, 20 OC steps
     each through the CLI;
 28. ``utils.mg_benchmark --fields 2 --refined --kernels on`` at 64x32x32:
     the 18 operating points, each compliance error within 10 x its tol;
 29. ``utils.neural_throughput 21 cheb2_mgl2``;
 30. ``parallel.validate_2d --dims 32,16,16 --steps 2``: unsharded, 4 slabs
     and 2x2 pencils, 4 ranks sharing the card over gloo, the trajectories
     within 5e-3.

The ranks of paths 21-23 and 30 are processes (``parallel.launch.spawn``), each
with its own launch counters, set to 0 before its run and read after it.
One card shows the sharded code paths, not their scaling.

Any failed check exits non-zero. The last line of standard output is one
JSON object naming the device; the line before it, the card's name and
power limit; the line before that, the kernels' JSON record.

Imports no JAX and nothing of the JAX package: the machine with the card
need not have them.
"""

import contextlib
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import types

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")  # gitignored, removed at exit
GRID = (192, 96, 96)
MGL = 3
ITERS = 5
CG_CAP = 100
PROB = "problems/3d/cantilever_flexion.json"
MBB = "problems/2d/mbb_beam.json"
BRIDGE = "problems/3d/bridge.json"
BENCH_GRID = (64, 32, 16)
NEURAL_STEPS = 4
BENCH_STEPS = 10
# small shapes of tests/test_pallas.py, then the paths' own fine grids
# (37x21, 37x19x23, 9x5x1: dims that are no multiple of the fp32 kernels'
# tiles or slabs, a one-element-thick 3-D grid)
TEST_SHAPES = [("problems/2d/mbb_beam.json", (12, 6)),
               ("problems/2d/mbb_beam.json", (10, 7)),
               ("problems/2d/mbb_beam.json", (37, 21)),
               ("problems/3d/cantilever_flexion.json", (8, 4, 4)),
               ("problems/3d/cantilever_flexion.json", (6, 4, 2)),
               (BRIDGE, (37, 19, 23)),
               (BRIDGE, (9, 5, 1)),
               (BRIDGE, BENCH_GRID)]
# the 2-D MBB grid of the reference's float64 log (phase 15, mgl=2)
MBB_GRID = (300, 100)
TOL_F32 = 1e-5      # max|f - f_twin| / max|f_twin|: summation order differs
TOL_F64 = 1e-12
TOL_ON_OFF = 1e-4   # the solver's tolerance; both runs are f64-refined to it
# GS against Chebyshev at step 0: two smoothers, each solve stopped at the
# 1e-4 residual test
TOL_GS_CHEB = 1e-3
GS_ITERS = 3
# the evaluator's CG cap per pass; the counts printed are summed over the
# refinement passes, so a sum below it means no pass reached it
EVAL_CG_CAP = 200
# (test grid, mgl): 2x and 4x the bench grid, its aspect kept (the CLI's
# mgl=1 would factor a 64x32x16 coarsest grid densely: 109k DoFs, 48 GB)
FOURFEAT_EVALS = (((128, 64, 32), 3), ((256, 128, 64), 4))
# the cantilever's production grid (tests/test_golden.py), level 1 cached
VOXEL_EVAL = ((256, 128, 128), 5)
# the JAX package's production classic configuration (bench.py, README.md):
# 256x128x128 mgl=5, a lag-8 preconditioner, a 32-step chunk
PROD_GRID, PROD_MGL, PROD_STEPS, PROD_LAG, PROD_SCAN = (256, 128, 128), 5, 32, 8, 32
# fresh OC steps before a lagged run (scripts/profile_oc.py --warm 20)
WARM_STEPS = 20
TOL_STEP0 = 1e-6     # step 0 of (b), (c) against (a): the same first hierarchy
TOL_LAG = 1e-4       # lagged against fresh histories (tests/test_training.py:176)
TOL_GRAPH = 1e-5     # (c) against (b): the same steps, replayed
TOL_NEURAL_LAG = 2e-3  # tests/test_training.py:56-60
GS_LAG_STEPS = 4
# 2 x the objective after OC steps 1-8 of the reference's 2-D MBB 300x100
# float64 log, and the first 5 OC objectives of its cantilever 256x128x128
# log, as tests/test_golden.py transcribes them (REFERENCE_TRACE,
# C1001_HEAD; copied: that test imports JAX), with its tolerances
REFERENCE_TRACE = [2661.300, 1701.628, 1298.092, 1080.876,
                   933.508, 842.956, 746.392, 647.912]
TOL_REFERENCE = 2e-4
C1001_HEAD = [1864.918446, 730.583631, 394.019948, 302.953550, 289.046282]
TOL_C1001 = 3e-3
X64_ITERS_ON, X64_ITERS_OFF = 3, 2
TOL_X64_ON_OFF = 1e-10  # float64 end to end: both runs solve to 1e-4, rounding apart
X64_NEURAL_STEPS = 3
LBFGS_ITERS = 20
TOL_VOLUME = 1e-4
# the same L-BFGS run in float64 on the card: its first inner iterations
# against the fp32-refined run's (both solve to the 1e-4 residual test;
# the curvature pairs carry the solves' difference from step to step)
LBFGS_X64_ITERS = 4
TOL_LBFGS_X64 = 1e-3
# L-BFGS in float64 on the card and on the CPU, at a grid the CPU solves
# in seconds: every history value and the final design (kernels against
# their plain twins, ~1e-15 per apply; the CPU parity test's tolerance)
LBFGS_SMALL_GRID, LBFGS_SMALL_MGL, LBFGS_SMALL_ITERS = (32, 16, 16), 2, 10
TOL_LBFGS_CPU = 1e-8
DEGREE2_GRID = (32, 16, 16)
DEGREE2_ITERS = 3
DEGREE2_CG_CAP = 2000   # ground_truth_topopt's cap for block-Jacobi PCG
TOL_LANGELAAR = 1e-12
# periodic homogenization (path 16): unit cells of an isotropic material,
# E = 1, nu = 0.3 (tests/test_homogenization.py); 64^3 cells have 262,144
# periodic nodes, 786k DoFs per cell problem, six problems
HOM_GRID, HOM_CPU_GRID = (64, 64, 64), (32, 32, 32)
HOM_E, HOM_NU = 1.0, 0.3
HOM_CAP = 2000           # design_microstructure's CG cap (solve_cell_problems)
HOM_TRACE_ITERS = 20
HOM_TOL = 1e-9           # design_microstructure's CG tolerance
HOM_TOL_LAMINATE = 1e-10
HOM_TOL_CPU = 1e-10      # card against CPU at 32^3
TOL_BACKUS = 1e-6        # the laminate against its closed form (JAX's test)
TOL_SYMMETRIC = 1e-9
TOL_HOM_CPU = 1e-9       # of max|Eh|
FD_H, FD_TOL, TOL_FD = 1e-6, 1e-12, 2e-5   # tests/test_homogenization.py's FD check
DESIGN_STEPS, DESIGN_LR = 10, 0.3
# continual learning at the north star's width (path 18)
CL_ITERS, CL_TASK_END = 4, 2
CL_RE = re.compile(r"Task (\d+) step (\d+): compliance (\S+), cg_iters (\d+)")
TOL_ZOO = 1e-12          # float64 card against CPU, forward and gradients
ZOO_SIREN_GRID = (192, 96)
# the sharded classic path (path 21): GRID as 2 slabs and as 2x2 pencils,
# its ranks sharing the card over gloo (halos staged through host memory);
# the local grids each rank's fine kernels run on
SHARDS = (2, (2, 2))
LOCAL_SHAPES = {"slab": (GRID[0] // 2,) + GRID[1:],
                "pencil": (GRID[0] // 2, GRID[1] // 2) + GRID[2:]}
SHARDED_TIMEOUT = 600
# path 22: the sharded solver on one rank over NCCL against the unsharded
# MGPCG, both refined to NCCL_SOLVE_TOL
NCCL_SOLVE_TOL, TOL_NCCL = 1e-8, 1e-6

# the reproduction and measurement tools (paths 24-30)
TOL_ENTRY = 1e-4          # entry() card against CPU: both solves refined to tol 1e-4
TOL_LEVEL_KE = 1e-12      # float64 Galerkin level stiffnesses, card against CPU
REPRO_RUNS, REPRO_ITERS = ("mbb300", "c3d_256"), 20
ENVELOPE_GRID, ENVELOPE_FIELDS = (64, 32, 32), 2
THROUGHPUT_CONFIG, THROUGHPUT_STEPS = "cheb2_mgl2", 21
VALIDATE_DIMS, VALIDATE_STEPS, VALIDATE_RANKS = (32, 16, 16), 2, 4


def validate_local_shapes() -> dict:
    """The local blocks of VALIDATE_DIMS on validate_2d's VALIDATE_RANKS
    slabs and (VALIDATE_RANKS/2) x 2 pencils."""
    nx, ny, nz = VALIDATE_DIMS
    r = VALIDATE_RANKS
    return {"validate slab": (nx // r, ny, nz),
            "validate pencil": (nx // (r // 2), ny // 2, nz)}
# H100 SXM data-sheet peaks (dense, no sparsity) at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
# both off the tensor cores, where the kernels' FMAs run: float32 on the CUDA
# cores, float64 on the FP64 cores (the reflection design's 3x3 blocks and
# transforms are no GEMM the FP64 tensor cores' 67 TFLOP/s could take)
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

FINE = {  # wrapper -> (source, replaced TPU kernel, dtype)
    "apply_k_fine_f32": ("ndr_tpu_torch/csrc/fine_stream.cu",
                         "ndr_tpu/fem/pallas_kernels.py:395", torch.float32),
    "apply_k_fine_elem_f32": ("ndr_tpu_torch/csrc/fine_elem.cu",
                              "ndr_tpu/fem/pallas_kernels.py:238", torch.float32),
    "apply_k_fine_f64": ("ndr_tpu_torch/csrc/fine_stream.cu",
                         "ndr_tpu/fem/pallas_kernels.py:636", torch.float64),
    "apply_k_fine_elem_f64": ("ndr_tpu_torch/csrc/fine_elem.cu",
                              "ndr_tpu/fem/pallas_kernels.py:852", torch.float64),
}
CACHED = {  # wrapper -> (source, replaced TPU kernel or its operand layout)
    "apply_k_cached_f32": ("ndr_tpu_torch/csrc/cached_stencil.cu",
                           "ndr_tpu/fem/pallas_kernels.py:1096"),
    "cached_stencil": ("ndr_tpu_torch/csrc/cached_stencil.cu",
                       "ndr_tpu/fem/pallas_kernels.py:1075"),
    # the same TPU kernel on a bf16 Ke stream (cached_ke_dtype="bfloat16")
    "apply_k_cached_bf16": ("ndr_tpu_torch/csrc/cached_stencil.cu",
                            "ndr_tpu/fem/pallas_kernels.py:1096"),
    "cached_stencil_bf16": ("ndr_tpu_torch/csrc/cached_stencil.cu",
                            "ndr_tpu/fem/pallas_kernels.py:1075"),
    # its function in float64, for the cached levels of a float64 hierarchy
    "apply_k_cached_f64": ("ndr_tpu_torch/csrc/cached_stencil.cu",
                           "ndr_tpu/fem/pallas_kernels.py:1096"),
    "cached_stencil_f64": ("ndr_tpu_torch/csrc/cached_stencil.cu",
                           "ndr_tpu/fem/pallas_kernels.py:1075"),
}
SLEEP_CYCLES = 200_000_000   # ~0.1 s of device time: the host queues all timed reps in it


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def port_modules() -> types.SimpleNamespace:
    """Every module of the port this script uses (imported here, not at the
    top, so that the script fails cleanly where the port is missing)."""
    from ndr_tpu_torch import grid, models
    from ndr_tpu_torch.eval import eval_fourfeat, eval_voxelfem
    from ndr_tpu_torch.fem import (element, homogenization, kernels, microstructure,
                                   multigrid, simulator)
    from ndr_tpu_torch.io import problem
    from ndr_tpu_torch.ops import filters
    from ndr_tpu_torch.ops import volume
    from ndr_tpu_torch.parallel import dryrun, validate_2d
    from ndr_tpu_torch.training import neural, train_cl, train_voxelfem, train_xdg
    from ndr_tpu_torch.utils import (mg_benchmark, neural_throughput, profile_oc, reproduce,
                                     timers, torch_setup)
    return types.SimpleNamespace(kernels=kernels, mg=multigrid, simulator=simulator,
                                 problem=problem, train_voxelfem=train_voxelfem,
                                 train_xdg=train_xdg, torch_setup=torch_setup,
                                 eval_fourfeat=eval_fourfeat, eval_voxelfem=eval_voxelfem,
                                 filters=filters, profile_oc=profile_oc, grid=grid,
                                 element=element, hom=homogenization, ms=microstructure,
                                 train_cl=train_cl, models=models, neural=neural,
                                 volume=volume, dryrun=dryrun, validate_2d=validate_2d,
                                 mg_benchmark=mg_benchmark,
                                 neural_throughput=neural_throughput, reproduce=reproduce,
                                 timers=timers)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of fn() in ms from CUDA events, with the L2
    flushed before each launch (the solver finds its operands cold). Every
    rep is queued behind a device sleep, so the events time the device's
    work and not the host's Python between them."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for a, b in events:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def errors(out, ref):
    diff = float((out.double() - ref.double()).abs().max())
    return diff, diff / float(ref.double().abs().max())


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fine_cost(grid, dtype) -> tuple:
    """(bytes, operations) of one fine apply: u, young and f once each; the
    operations of the kernels' design, the reflection basis (both types):
    the two transforms (in 3-D the lower node plane's is carried from the
    previous element), 2^N N x N blocks, the young scale fused with the
    carried forces."""
    b = torch.finfo(dtype).bits // 8
    nn, ne, N = grid.num_nodes, grid.num_elements, grid.ndim
    npe = grid.nodes_per_elem
    d = npe * N
    L = npe.bit_length() - 1
    flops = ne * (2 * d * L - (d if N == 3 else 0) + 2 * npe * N * N + 2 * d)
    return 2 * N * nn * b + ne * b, flops


def stencil_from_blocks(kernels, grid, block, dtype):
    """The node stencil (``kernels.stencil_shape``) of K from per-element
    blocks: ``block(a, b)`` is the (dims..., N, N) coupling of local node
    a's rows to local node b's columns (the fine level's E_e K0 blocks,
    made one at a time)."""
    N = grid.ndim
    offs = kernels.stencil_offsets(N)
    local = list(itertools.product((0, 1), repeat=N))
    S = torch.zeros(kernels.stencil_shape(grid), dtype=dtype, device="cuda")
    for a, ab in enumerate(local):
        rows = tuple(slice(o, o + n) for o, n in zip(ab, grid.dims))
        for b, bb in enumerate(local):
            o = offs.index(tuple(y - x for x, y in zip(ab, bb)))
            S[(o, slice(None), slice(None)) + rows] += block(a, b).to(dtype).movedim(
                (-2, -1), (0, 1))
    return S


def fine_csr(kernels, args, grid):
    """The library call of a fine apply on ``args`` = (u, young, K0): a
    thunk giving (K of the grid as CSR, u as a vector)."""
    def library():
        u, young, ke = args
        N = grid.ndim
        S = stencil_from_blocks(kernels, grid, lambda a, c: young[..., None, None]
                                * ke[a * N:(a + 1) * N, c * N:(c + 1) * N], u.dtype)
        K = stencil_csr(kernels, grid, S)
        del S
        return K, u.reshape(-1)
    return library


def stencil_csr(kernels, grid, S):
    """K of a degree-1 grid as a CSR matrix (int32 indices) from its node
    stencil S: row (n, c) holds all 3^N N neighbour columns, in the
    stencil's offset order; entries outside the grid are zero."""
    N = grid.ndim
    nodes = grid.nodes_per_dim
    offs = kernels.stencil_offsets(N)
    dev = S.device
    n_nodes = grid.num_nodes
    strides = [int(math.prod(nodes[k + 1:])) for k in range(N)]
    idx = torch.arange(n_nodes, device=dev)
    coords = [(idx // strides[k]) % nodes[k] for k in range(N)]
    nbr = []
    for o in offs:
        ok = torch.ones_like(idx, dtype=torch.bool)
        flat = torch.zeros_like(idx)
        for k in range(N):
            ck = coords[k] + o[k]
            ok &= (ck >= 0) & (ck < nodes[k])
            flat += ck.clamp(0, nodes[k] - 1) * strides[k]
        nbr.append(torch.where(ok, flat, idx))
    nbr = torch.stack(nbr, 1)                                    # (nodes, 3^N)
    d = torch.arange(N, device=dev)
    cols = (nbr[:, None, :, None] * N + d[None, None, None, :]).expand(
        n_nodes, N, len(offs), N).reshape(n_nodes * N, -1).to(torch.int32)
    # (o, c, d, node) -> row (node, c), columns (o, d)
    v = S.reshape(len(offs), N, N, n_nodes).permute(3, 1, 0, 2).reshape(
        n_nodes * N, -1).contiguous()
    per_row = v.shape[1]
    crow = torch.arange(0, n_nodes * N * per_row + 1, per_row, dtype=torch.int32,
                        device=dev)
    K = torch.sparse_csr_tensor(crow, cols.reshape(-1).contiguous(), v.reshape(-1),
                                size=(n_nodes * N, n_nodes * N),
                                check_invariants=False)
    return K


def phase_environment():
    from torch.utils.cpp_extension import CUDA_HOME

    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}")
    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    rel = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    print("nvcc:", [l for l in rel.splitlines() if "release" in l][0].strip())
    print("gpu:", gpu_line())


PTXAS_FN_RE = re.compile(
    r"(?:Compiling entry function|Function properties for) '?([\w.$]+)'?")
PTXAS_SPILL_RE = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
PTXAS_REGS_RE = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str) -> dict:
    """{function: [registers, spill bytes]} from ``nvcc -Xptxas -v`` output,
    names demangled where ``c++filt`` is there."""
    out, fn = {}, None
    for line in log.splitlines():
        if (mt := PTXAS_FN_RE.search(line)):
            fn = mt.group(1)
            out.setdefault(fn, [None, 0])
        elif fn and (mt := PTXAS_SPILL_RE.search(line)):
            out[fn][1] += int(mt.group(1)) + int(mt.group(2))
        elif fn and (mt := PTXAS_REGS_RE.search(line)):
            out[fn][0] = int(mt.group(1))
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(out), capture_output=True,
                               text=True, check=True, timeout=60).stdout.splitlines()
        names = [n.replace("(anonymous namespace)::", "").split("(")[0]
                 .removeprefix("void ") for n in names]
        out = dict(zip(names, out.values()))
    return out


def phase_build(m):
    """Builds the kernels; prints each kernel's registers and spills from
    ``ptxas`` and fails on any spill."""
    seconds = m.kernels.build()
    print(f"build: {seconds:.2f} s -> {m.kernels.build_info['path']}")
    report = ptxas_report(str(m.kernels.build_info["log"]))
    check(report, "build: no ptxas lines in the compiler output")
    for fn, (regs, spill) in report.items():
        print(f"  ptxas: {regs} registers, {spill} bytes spilled: {fn}")
    spilled = [fn for fn, (_, spill) in report.items() if spill]
    check(not spilled, f"build: ptxas spills registers in {spilled}")


def phase_kernels(m):
    """Each kernel against its twin at the test shapes and the paths'
    shapes; at 192x96x96 and 64x32x16 (cached apply and stencil assembly:
    the levels of their hierarchies) each is timed beside its bound, its
    twin and, for the applies, the CSR SpMV. Returns (worst abs error,
    records)."""
    import numpy as np

    kernels = m.kernels
    dev = torch.device("cuda")
    worst = {name: 0.0 for name in kernels.launches}
    records = {}

    def run(name, kernel, plain, args, grid, tol, label, cost=None, library=None):
        out = kernel(*args, grid)
        torch.cuda.synchronize()
        ref = plain(*args, grid)
        abs_err, rel_err = errors(out, ref)
        if tol == 0:
            check(torch.equal(out, ref), f"{name} at {label}: not bitwise equal, "
                                         f"rel err {rel_err:.3e}")
        check(math.isfinite(rel_err) and rel_err <= tol,
              f"{name} at {label}: rel err {rel_err:.3e} > {tol:g}")
        worst[name] = max(worst[name], abs_err)
        line = f"{name:22s} {label:30s} max|d| {abs_err:.3e}  rel {rel_err:.3e}"
        if cost is not None:
            nbytes, flops, dtype = cost
            ms = time_ms(lambda: kernel(*args, grid))
            plain_ms = time_ms(lambda: plain(*args, grid))
            lib_ms = None
            if library is not None:
                K, vec = library()
                lib_err = errors(K @ vec, ref.reshape(-1))[1]
                check(lib_err < tol, f"{name} library SpMV at {label}: rel {lib_err:.3e}")
                lib_ms = time_ms(lambda: K @ vec)
                del K, vec
            b_ms, b_by = bound(nbytes, flops, dtype)
            line += (f"\n    kernel {ms:.4f} ms, {nbytes / 1e6:.1f} MB "
                     f"({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s), {flops / 1e9:.2f} GFLOP; "
                     f"bound {b_ms:.4f} ms by {b_by} ({b_ms / ms:.1%} of it); "
                     f"plain {plain_ms:.4f} ms; library "
                     + ("-" if lib_ms is None else f"{lib_ms:.4f} ms"))
            records.setdefault(name, []).append(dict(
                shape=label, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops))
        print(line, flush=True)
        return out

    def cached(ke, g, label, timed, ke64):
        """Assembly and apply of one cached level's stencil: from the fp32
        stack ``ke`` (fp32 and bf16 storage) and from the float64 stack
        ``ke64`` (the float64 instances)."""
        N = g.ndim
        d = g.nodes_per_elem * N
        nn, ne = g.num_nodes, g.num_elements
        slots = 3 ** N * N * N
        S = run("cached_stencil", kernels.cached_stencil, kernels.cached_stencil_plain,
                (ke,), g, 0, label,
                cost=(4 * d * d * ne + 4 * slots * nn, d * d * ne, torch.float32)
                if timed else None)
        ul = torch.tensor(rng.standard_normal(g.nodes_per_dim + (N,)),
                          dtype=torch.float32, device=dev)
        run("apply_k_cached_f32", kernels.apply_k_cached_f32,
            kernels.apply_k_cached_f32_plain, (ul, S), g, TOL_F32, label,
            cost=(4 * slots * nn + 8 * N * nn, 2 * slots * nn, torch.float32)
            if timed else None,
            library=(lambda: (stencil_csr(kernels, g, S), ul.reshape(-1)))
            if timed else None)
        if timed:  # what the per-element Ke stack apply had to move: the stack, u and f
            old = bound(4 * d * d * ne + 8 * N * nn, 2 * d * d * ne, torch.float32)
            print(f"    bound of the per-element Ke stack it replaces: {old[0]:.4f} ms "
                  f"by {old[1]} ({(4 * d * d * ne + 8 * N * nn) / 1e6:.1f} MB)")
        # the bf16 storage: 2 B per stencil entry; the library SpMV takes the
        # rounded entries widened to fp32
        S16 = run("cached_stencil_bf16", kernels.cached_stencil_bf16,
                  kernels.cached_stencil_bf16_plain, (ke,), g, 0, label,
                  cost=(4 * d * d * ne + 2 * slots * nn, d * d * ne, torch.float32)
                  if timed else None)
        run("apply_k_cached_bf16", kernels.apply_k_cached_bf16,
            kernels.apply_k_cached_bf16_plain, (ul, S16), g, TOL_F32, label,
            cost=(2 * slots * nn + 8 * N * nn, 2 * slots * nn, torch.float32)
            if timed else None,
            library=(lambda: (stencil_csr(kernels, g, S16.float()), ul.reshape(-1)))
            if timed else None)
        del S, S16
        # float64: 8 B per Ke, stencil, u and f entry; the library SpMV is
        # cuSPARSE's float64 CSR
        S64 = run("cached_stencil_f64", kernels.cached_stencil_f64,
                  kernels.cached_stencil_f64_plain, (ke64,), g, 0, label,
                  cost=(8 * d * d * ne + 8 * slots * nn, d * d * ne, torch.float64)
                  if timed else None)
        u64 = ul.double()
        run("apply_k_cached_f64", kernels.apply_k_cached_f64,
            kernels.apply_k_cached_f64_plain, (u64, S64), g, TOL_F64, label,
            cost=(8 * slots * nn + 16 * N * nn, 2 * slots * nn, torch.float64)
            if timed else None,
            library=(lambda: (stencil_csr(kernels, g, S64), u64.reshape(-1)))
            if timed else None)

    # the hierarchies the paths build: every level but the coarsest
    # (factored); paths 24-30 add entry()'s grid (mgl=1: the fine level
    # alone), the envelope's and reproduce c3d_256's (the production grid)
    path_levels = {GRID: MGL, BENCH_GRID: 2, MBB_GRID: 2, m.dryrun.ENTRY_DIMS: 1,
                   ENVELOPE_GRID: 3, PROD_GRID: PROD_MGL}
    tool_shapes = [(PROB, m.dryrun.ENTRY_DIMS), (PROB, ENVELOPE_GRID), (PROB, PROD_GRID)]
    rng = np.random.default_rng(0)
    for prob_path, dims in TEST_SHAPES + [(MBB, MBB_GRID), (PROB, GRID)] + tool_shapes:
        timed = dims in (GRID, BENCH_GRID)
        prob, grid = m.simulator.problem_from_config(
            m.problem.load_problem(prob_path), dims=dims, device=dev)
        rho = torch.tensor(rng.uniform(1e-3, 1.0, grid.dims), device=dev)
        u = torch.tensor(1e3 * rng.standard_normal(grid.nodes_per_dim + (grid.ndim,)),
                         device=dev)
        young = prob.young(rho)
        nn, ne, N = grid.num_nodes, grid.num_elements, grid.ndim
        d = grid.nodes_per_elem * N
        for name, (_, _, dt) in FINE.items():
            b = torch.finfo(dt).bits // 8
            args = (u.to(dt), young.to(dt), prob.K0.to(dt))
            tol = TOL_F32 if dt == torch.float32 else TOL_F64

            library = fine_csr(kernels, args, grid)
            # and of the dense K0 contraction (with the young scale) that
            # the reflection design replaced
            dense_flops = ne * (2 * d * d + d)
            io_bytes, flops = fine_cost(grid, dt)

            run(name, getattr(kernels, name), kernels.apply_k_fine_plain, args, grid,
                tol, f"fine {dims}", cost=(io_bytes, flops, dt) if timed else None,
                library=library if timed else None)
            if timed:
                dense = bound(io_bytes, dense_flops, dt)
                print(f"    bound with the dense K0 contraction: {dense[0]:.4f} ms "
                      f"by {dense[1]} ({dense_flops / 1e9:.2f} GFLOP)")
            if timed and name.startswith("apply_k_fine_elem"):
                # not in its bound: the function needs only u, young and f
                slab, ty, tz, n_slots = kernels.elem_geometry(grid, dev, dt)
                scratch = b * N * n_slots
                print(f"    its design also moves a face-partials scratch of "
                      f"{scratch / 1e6:.1f} MB (slab {slab}, tile {ty}x{tz}), "
                      f"at most once each way: <= {(io_bytes + 2 * scratch) / 1e6:.1f} MB")
        if not timed and dims != PROD_GRID:
            # a random stack on the grid itself (any shape, coarsenable or
            # not; at PROD_GRID it would take 29 GB: its levels follow)
            ke = torch.tensor(rng.standard_normal(grid.dims + (d, d)),
                              dtype=torch.float32, device=dev)
            cached(ke, grid, f"random Ke {dims}", False, ke.double())

        # the Galerkin levels of this grid's hierarchy, built as the solver
        # builds them (level 1 direct, deeper levels recursive)
        nl = path_levels.get(dims, min(1, m.mg.max_feasible_coarsenings(grid)))
        cfg = m.mg.build_mg_config(prob, nl)
        ke = m.mg.build_level_ke(cfg, young.float(), 1) if nl else None
        ke64 = m.mg.build_level_ke(cfg, young, 1) if nl else None  # a float64 hierarchy's
        for l in range(1, nl + 1):
            if l > 1:
                ke = m.mg.coarsen_ke(ke, N)
                ke64 = m.mg.coarsen_ke(ke64, N)
            if l == nl and dims in path_levels:
                break  # the coarsest level is factored, not applied
            g = cfg.levels[l].grid
            cached(ke.contiguous(), g, f"level {l} {g.dims}", timed, ke64.contiguous())
        del ke, ke64
        torch.cuda.empty_cache()

    # the sharded solver's local grids (paths 21 and 30): each rank's level
    # 0 and float64 residual launch the flat32 pair on its block of GRID
    # (timed) and of VALIDATE_DIMS (4 slabs, 2x2 pencils)
    local_shapes = [(kind, GRID, local, True) for kind, local in LOCAL_SHAPES.items()]
    local_shapes += [(kind, VALIDATE_DIMS, local, False)
                     for kind, local in validate_local_shapes().items()]
    for kind, of, local, timed in local_shapes:
        prob, grid = m.simulator.problem_from_config(m.problem.load_problem(PROB), dims=of,
                                                     device=dev)
        g = grid.with_dims(local)
        u = torch.tensor(1e3 * rng.standard_normal(g.nodes_per_dim + (3,)), device=dev)
        young = prob.young(torch.tensor(rng.uniform(1e-3, 1.0, local), device=dev))
        for name in ("apply_k_fine_f32", "apply_k_fine_f64"):
            dt = FINE[name][2]
            args = (u.to(dt), young.to(dt), prob.K0.to(dt))
            io_bytes, flops = fine_cost(g, dt)
            run(name, getattr(kernels, name), kernels.apply_k_fine_plain, args, g,
                TOL_F32 if dt == torch.float32 else TOL_F64, f"{kind} {local} of {of}",
                cost=(io_bytes, flops, dt) if timed else None,
                library=fine_csr(kernels, args, g) if timed else None)
        del u, young
        torch.cuda.empty_cache()
    return worst, records


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


@contextlib.contextmanager
def captured_stderr():
    buf = io.StringIO()
    with contextlib.redirect_stderr(_Tee(sys.stderr, buf)):
        yield buf


CLASSIC_RE = re.compile(r"Total Steps: (\d+), Runtime: \S+, Compliance loss (\S+), "
                        r"constraint \S+, lambda \S+, cg_iters (\d+)")
NEURAL_RE = re.compile(r"Total Steps: (\d+), Compliance loss (\S+), loss (\S+), "
                       r"cg_iters (\d+)")


def run_path(m, label: str, fn, expect: tuple):
    """Drive one path with the launch counters zeroed just before and read
    just after; every kernel in ``expect`` must have launched."""
    m.kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    result = fn()
    torch.cuda.synchronize()
    counts = dict(m.kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{label}] launches {counts}, peak memory {peak:.2f} GiB")
    for name in expect:
        check(counts[name] > 0, f"{label}: {name} was not launched by the path")
    return result, counts, peak


def classic(m, kernels_mode: str, smoother: str = "chebyshev", iters: int = ITERS,
            grid=GRID, mgl: int = MGL, extra=(), jid=None, prob: str = PROB,
            cg_cap: int = CG_CAP):
    jid = jid or (f"classic_{kernels_mode}" if smoother == "chebyshev" else
                  f"classic_{smoother}_{kernels_mode}")
    argv = ["--prob", prob, "--grid", json.dumps(list(grid)), "--mgl", str(mgl),
            "--iter", str(iters), "--device", "cuda", "--kernels", kernels_mode,
            "--smoother", smoother, "--out", OUT_DIR, "--jid", jid, *extra]
    with captured_stderr() as buf:
        result = m.train_voxelfem.main(argv)
    text = buf.getvalue()
    steps = [(int(i), float(c), int(n)) for i, c, n in CLASSIC_RE.findall(text)]
    check([s[0] for s in steps] == list(range(iters)),
          f"{jid}: step lines {steps}")
    for i, c, n in steps:
        check(math.isfinite(c) and c > 0, f"classic step {i}: compliance {c}")
        check(n < cg_cap, f"classic step {i}: cg_iters {n} hit the cap {cg_cap}")
    check('Compliance loss of binary densities for "' in text
          and "Final step, Compliance loss" in text,
          f"{jid}: final reference-format lines missing")
    check(math.isfinite(result.compliance) and math.isfinite(result.binary_compliance),
          f"{jid}: final compliance not finite")
    check(result.densities.shape == tuple(grid), f"densities shape {result.densities.shape}")
    for f in (".vtr", "_densities.npy", "_history.json"):
        path = os.path.join(OUT_DIR, f"{jid}{f}")
        check(os.path.exists(path), f"artifact {path} missing")
    s_per_iter = statistics.median(result.step_seconds[1:])
    applies = re.search(r"Stiffness applies: (.*)", text)
    print(f"{jid}: compliance by step {[c for _, c, _ in steps]}, cg_iters "
          f"{[n for *_, n in steps]}, s/OC-iter (median of steps 1-{iters - 1}) "
          f"{s_per_iter:.4f}, solver {result.solver_stats}; stiffness applies: "
          f"{applies.group(1) if applies else '?'}")
    return steps, s_per_iter, result


def evaluation(label: str, cli, argv, res_key: str, dims):
    """One eval CLI run on the card: its JSON line holds finite positive
    compliances at ``dims`` and a binary volume in [0, 1]; returns
    (JSON line, result, wall seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        result = cli.main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(line[res_key] == list(dims), f"{label}: resolution {line[res_key]}")
    for k in ("compliance", "binary_compliance"):
        check(math.isfinite(line[k]) and line[k] > 0, f"{label}: {k} {line[k]}")
    check(0.0 <= line["binary_volume"] <= 1.0, f"{label}: b-vol {line['binary_volume']}")
    check(max(result.cg_iters) < EVAL_CG_CAP,
          f"{label}: cg_iters {result.cg_iters} hit the cap {EVAL_CG_CAP}")
    print(f"{label}: compliance {line['compliance']}, binary {line['binary_compliance']}, "
          f"b-vol {line['binary_volume']}, cg_iters (soft, binary) {result.cg_iters}, "
          f"wall {wall:.2f} s")
    return line, result, wall


def neural(m, jid: str, grid, mgl: int, vcs: str, steps: int, extra):
    argv = ["--prob", BRIDGE, "--grid", json.dumps(list(grid)), "--v0", "0.4",
            "--mgl", str(mgl), "--vcs", vcs, "--es", "1024", "--nn", "512",
            "--nl", "4", "--iter", str(steps), "--log-every", "1",
            "--device", "cuda", "--out", OUT_DIR, "--jid", jid] + list(extra)
    with captured_stderr() as buf:
        result = m.train_xdg.main(argv)
    text = buf.getvalue()
    lines = [(int(i), float(c), float(l), int(n))
             for i, c, l, n in NEURAL_RE.findall(text)]
    check([s[0] for s in lines] == list(range(1, steps + 1)),
          f"{jid}: step lines {lines}")
    for i, c, l, n in lines:
        check(math.isfinite(c) and c > 0 and math.isfinite(l),
              f"{jid} step {i}: compliance {c}, loss {l}")
        check(n < CG_CAP, f"{jid} step {i}: cg_iters {n} hit the cap {CG_CAP}")
    check("Resolution runtime: " in text and "Final compliance " in text
          and "b-vol=" in text, f"{jid}: final lines missing")
    check(math.isfinite(result.final_compliance)
          and math.isfinite(result.binary_compliance), f"{jid}: final compliance")
    check(result.densities.shape == tuple(grid)
          and bool(torch.isfinite(torch.as_tensor(result.densities)).all()),
          f"{jid}: densities {result.densities.shape}")
    for f in (".vtr", "_densities.npy", ".npz", "_history.json"):
        path = os.path.join(OUT_DIR, f"{jid}{f}")
        check(os.path.exists(path), f"artifact {path} missing")
    s_step = statistics.median(result.step_seconds[1:]) if steps > 1 else float("nan")
    print(f"{jid}: compliance by step {[c for _, c, _, _ in lines]}, "
          f"cg_iters {[n for *_, n in lines]}, s/step (median of steps after "
          f"step 0) {s_step:.4f}, final {result.final_compliance:.6f}, "
          f"binary {result.binary_compliance:.6f}, solver {result.solver_stats}")
    return lines, s_step, result


def solver_settings(m):
    """The fp32 bound-only MGPCG solve (refined in float64, Chebyshev,
    kernels on) at one random density, and beside it the same solve with
    ``cached_ke_dtype="bfloat16"`` and with ``lmax_power_iters=8``: the CG
    operator is exact, so each compliance within 1e-4 of the reference's;
    returns the lines to print in the summary (CG iterations, walls)."""
    import numpy as np

    prob, grid = m.simulator.problem_from_config(m.problem.load_problem(PROB), dims=GRID,
                                                 dtype=torch.float32, device="cuda")
    rho = torch.tensor(np.random.default_rng(21).uniform(0.05, 1.0, grid.dims),
                       dtype=torch.float32, device="cuda")
    f = prob.force.double().reshape(-1)
    base = dict(num_levels=MGL, smoother="chebyshev", cheb_degree=1)
    out, ref = [], None
    for label, extra in (("fp32 bound-only", {}), ("cached_ke_dtype=bfloat16",
                                                   {"cached_ke_dtype": "bfloat16"}),
                         ("lmax_power_iters=8", {"lmax_power_iters": 8})):
        solve = m.mg.make_mg_solver(prob, m.mg.MGSolverSettings(**base, **extra))
        solve(rho)  # the first call builds the kernels' state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, iters = solve(rho)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = float(f @ u.reshape(-1))
        check(math.isfinite(c) and c > 0 and iters < CG_CAP, f"{label}: c {c}, iters {iters}")
        if ref is None:
            ref = c
        rel = abs(c - ref) / abs(ref)
        check(rel < TOL_ON_OFF, f"{label}: compliance {c} vs fp32 {ref}: rel {rel:.3e}")
        out.append(f"solver settings {GRID} mgl={MGL} {label}: CG iterations {iters}, "
                   f"solve {wall:.4f} s, compliance rel to fp32 {rel:.3e}")
        print(out[-1])
    return out


def lbfgs_run(m, jid: str, iters: int, grid=GRID, mgl: int = MGL, device: str = "cuda",
              extra=()):
    """One ``train_voxelfem --optim LBFGS`` run on the cantilever: every
    compliance finite, one history value per inner iteration and the
    restored design's, that design feasible (filtered volume at most v0 +
    1e-4; the restoration moves only an infeasible design down onto v0).
    Returns (result, filtered volume, v0)."""
    argv = ["--prob", PROB, "--grid", json.dumps(list(grid)), "--mgl", str(mgl),
            "--iter", str(iters), "--optim", "LBFGS", "--device", device,
            "--log-every", "1", "--out", OUT_DIR, "--jid", jid, *extra]
    with captured_stderr():
        result = m.train_voxelfem.main(argv)
    hist = result.history
    n = len(result.step_seconds)
    check(n == iters and len(hist) == n + 1, f"{jid}: {n} iterations, "
                                             f"{len(hist)} history values")
    check(all(math.isfinite(c) and c > 0 for c in hist), f"{jid}: history {hist}")
    v0 = m.problem.load_problem(PROB).max_volume
    vol = float(result.physical.mean())
    check(vol <= v0 + TOL_VOLUME, f"{jid}: filtered volume {vol} > v0 {v0} + {TOL_VOLUME:g}")
    print(f"{jid} {grid} mgl={mgl} on {device}: {result.evaluations} objective evaluations, "
          f"history {hist}")
    return result, vol, v0


def lbfgs_path(m):
    """Classic SIMP with ``--optim LBFGS`` at 192x96x96 (fp32-refined
    solves), 20 inner iterations, twice: the restored design's compliance
    below step 0's, and the second run the same bits as the first (the
    port's gradient and coarsest assembly add in a fixed order). Then the
    same run in float64 for its first iterations, held to the fp32-refined
    history; then float64 on the card against the CPU at 32x16x16.
    Returns the summary line."""
    import numpy as np

    result, vol, v0 = lbfgs_run(m, "lbfgs", LBFGS_ITERS)
    hist = result.history
    check(hist[-1] < hist[0], f"lbfgs: final {hist[-1]} not below step 0's {hist[0]}")
    again, _, _ = lbfgs_run(m, "lbfgs_again", LBFGS_ITERS)
    check(again.history == hist and again.evaluations == result.evaluations
          and np.array_equal(again.densities, result.densities),
          f"lbfgs: a second run from the same start differs: {again.evaluations} "
          f"evaluations, history {again.history}")
    print("lbfgs: the second run equals the first bitwise (history, evaluations, design)")

    x64, _, _ = lbfgs_run(m, "lbfgs_x64", LBFGS_X64_ITERS, extra=("--x64",))
    k = LBFGS_X64_ITERS
    rel_x64 = max(abs(a - b) / abs(b) for a, b in zip(hist[:k], x64.history[:k]))
    print(f"lbfgs fp32-refined against float64, inner iterations 0-{k - 1}: "
          f"{hist[:k]} vs {x64.history[:k]}, worst rel {rel_x64:.3e}")
    check(rel_x64 <= TOL_LBFGS_X64, f"lbfgs fp32-refined differs from float64: "
                                    f"rel {rel_x64:.3e} > {TOL_LBFGS_X64:g}")

    small = dict(grid=LBFGS_SMALL_GRID, mgl=LBFGS_SMALL_MGL, extra=("--x64",))
    card, _, _ = lbfgs_run(m, "lbfgs_small_cuda", LBFGS_SMALL_ITERS, **small)
    host, _, _ = lbfgs_run(m, "lbfgs_small_cpu", LBFGS_SMALL_ITERS, device="cpu", **small)
    rel_h = max(abs(a - b) / abs(b) for a, b in zip(card.history, host.history))
    err_x = float(np.abs(card.densities - host.densities).max())
    print(f"lbfgs float64 {LBFGS_SMALL_GRID} card against CPU: evaluations "
          f"{card.evaluations} / {host.evaluations}, history worst rel {rel_h:.3e}, "
          f"final design max|d| {err_x:.3e}")
    check(card.evaluations == host.evaluations and rel_h <= TOL_LBFGS_CPU
          and err_x <= TOL_LBFGS_CPU,
          f"lbfgs float64 card differs from the CPU: evaluations {card.evaluations} / "
          f"{host.evaluations}, history rel {rel_h:.3e}, design {err_x:.3e} "
          f"(tolerance {TOL_LBFGS_CPU:g})")

    s_it = statistics.median(result.step_seconds)
    line = (f"lbfgs {GRID} mgl={MGL}: {len(result.step_seconds)} inner iterations, "
            f"{result.evaluations} objective evaluations, s per inner iteration "
            f"{s_it:.4f} (median), compliance {hist[0]:.6f} -> {hist[-1]:.6f}, filtered "
            f"volume {vol:.6f} (v0 {v0}, v0 - vol {v0 - vol:.3e}); reproduced bitwise; "
            f"float64 iterations 0-{k - 1} within {rel_x64:.3e}; float64 "
            f"{LBFGS_SMALL_GRID} card vs CPU history {rel_h:.3e}, design {err_x:.3e}")
    print(line)
    return line, result


def degree2_problem() -> str:
    """The cantilever's problem JSON with orderFEM [2, 2, 2], written under
    the output directory (asset paths absolute)."""
    with open(os.path.join(ROOT, PROB)) as f:
        cfg = json.load(f)
    cfg["orderFEM"] = [2, 2, 2]
    for key in ("MATERIAL_PATH", "BC_PATH"):
        cfg[key] = os.path.join(ROOT, cfg[key])
    path = os.path.join(OUT_DIR, "cantilever_degree2.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def langelaar(m) -> str:
    """The Langelaar overhang filter at 192x96x96 in float64, forward and
    backward (autograd) on the card against the same call on the CPU, each
    within 1e-12 (of max|grad| for the gradient); a traced call's device
    busy time and ops. Returns the summary line."""
    import numpy as np

    rng = np.random.default_rng(31)
    x = rng.uniform(0.02, 1.0, GRID)
    w = rng.standard_normal(GRID)
    filt = m.filters.LangelaarFilter()

    def fwd_bwd(dev):
        xt = torch.tensor(x, device=dev, requires_grad=True)
        y = filt.apply(xt)
        g, = torch.autograd.grad(y, xt, torch.tensor(w, device=dev))
        return y.detach(), g

    fwd_bwd("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, g = fwd_bwd("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fwd_bwd("cuda")
        torch.cuda.synchronize()
    busy, n_ops, _, _ = m.profile_oc.device_summary(prof)
    y_cpu, g_cpu = fwd_bwd("cpu")
    err_y = float((y.cpu() - y_cpu).abs().max())
    err_g = float((g.cpu() - g_cpu).abs().max() / g_cpu.abs().max())
    check(err_y <= TOL_LANGELAAR and err_g <= TOL_LANGELAAR,
          f"langelaar card vs CPU: forward {err_y:.3e}, gradient rel {err_g:.3e}")
    line = (f"langelaar {GRID} float64 forward+backward: wall {wall:.4f} s over "
            f"{GRID[-1]} layers; traced: {n_ops} device ops, busy {1e3 * busy:.2f} ms "
            f"(host-bound: a loop over layers); card vs CPU forward {err_y:.3e}, "
            f"gradient rel {err_g:.3e}")
    print(line)
    return line


def unit_cell(m, dims):
    """(grid, material, K0 as a float64 CUDA tensor) of a unit cell of the
    isotropic material of path 16."""
    grid = m.grid.make_grid(dims, [[0] * len(dims), [1] * len(dims)])
    mat = m.element.IsotropicMaterial(HOM_E, HOM_NU, grid.ndim)
    K0 = m.element.element_stiffness_matrix(tuple([1] * grid.ndim), grid.stretchings, mat)
    return grid, mat, torch.tensor(K0, device="cuda")


def periodic_kernel_checks(m, records, worst):
    """Path 16 (a): both fine kernels against their twin on the expanded
    (65^3-node) field of a 64^3 cell, and the periodic apply through them
    against the plain periodic apply; each timed beside its twin at that
    shape (added to the kernels' records)."""
    import numpy as np

    hom, kernels = m.hom, m.kernels
    grid, _, K0 = unit_cell(m, HOM_GRID)
    rng = np.random.default_rng(5)
    u = torch.tensor(rng.standard_normal(grid.dims + (3,)), device="cuda")
    rho = torch.tensor(rng.uniform(0.3, 1.0, grid.dims), device="cuda")
    for name, dtype, tol in (("apply_k_fine_f64", torch.float64, TOL_F64),
                             ("apply_k_fine_f32", torch.float32, TOL_F32)):
        ud, rd, kd = u.to(dtype), rho.to(dtype), K0.to(dtype)
        full = hom.periodic_expand(ud, 3)
        kernel = getattr(kernels, name)
        out = kernel(full, rd, kd, grid)
        ref = kernels.apply_k_fine_plain(full, rd, kd, grid)
        abs_err, rel = errors(out, ref)
        per = hom.periodic_apply_k(ud, rd, kd, grid, use_kernels=True)
        per_ref = hom.periodic_apply_k(ud, rd, kd, grid, use_kernels=False)
        rel_per = errors(per, per_ref)[1]
        check(rel <= tol and rel_per <= tol,
              f"{name} at the periodic {HOM_GRID} cell: rel err {rel:.3e}, periodic "
              f"apply {rel_per:.3e} > {tol:g}")
        worst[name] = max(worst[name], abs_err)
        nbytes, flops = fine_cost(grid, dtype)
        ms = time_ms(lambda: kernel(full, rd, kd, grid))
        plain_ms = time_ms(lambda: kernels.apply_k_fine_plain(full, rd, kd, grid))
        # the library call: cuSPARSE CSR SpMV with K of the expanded grid
        K, vec = fine_csr(kernels, (full, rd, kd), grid)()
        lib_rel = errors(K @ vec, ref.reshape(-1))[1]
        check(lib_rel < tol, f"{name} library SpMV at the periodic cell: rel {lib_rel:.3e}")
        lib_ms = time_ms(lambda: K @ vec)
        del K, vec
        b_ms, b_by = bound(nbytes, flops, dtype)
        label = f"periodic {HOM_GRID} ({grid.nodes_per_dim} nodes)"
        records.setdefault(name, []).append(dict(
            shape=label, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
            bound_by=b_by, bytes=nbytes, flops=flops))
        print(f"{name:22s} {label:30s} max|d| {abs_err:.3e}  rel {rel:.3e}; periodic "
              f"apply with/without kernels rel {rel_per:.3e}\n    kernel {ms:.4f} ms; "
              f"bound {b_ms:.4f} ms by {b_by} ({b_ms / ms:.1%} of it); plain {plain_ms:.4f} "
              f"ms; library {lib_ms:.4f} ms")


def laminate_tensor(lam: float, mu: float):
    """Closed-form (Backus) tensor entries of the path-16 laminate (layers
    normal to x, half the cell at density 0.25): C11 = <1/M>^-1 with
    M = lam + 2 mu, C12 = C13 = <lam/M> C11, the xy and xz shears
    <1/mu>^-1, the yz shear <mu>."""
    phases = ((0.5, 0.25), (0.5, 1.0))

    def avg(f):
        return sum(frac * f(s * lam, s * mu) for frac, s in phases)

    C11 = 1.0 / avg(lambda l, m: 1.0 / (l + 2 * m))
    C12 = avg(lambda l, m: l / (l + 2 * m)) * C11
    return C11, C12, 1.0 / avg(lambda l, m: 1.0 / m), avg(lambda l, m: m)


def homogenization_path(m):
    """Path 16 (b)-(d) in float64; returns (summary line, the laminate's
    tensor, the 64^3 cell's grid and material)."""
    import numpy as np

    hom = m.hom
    grid, mat, K0 = unit_cell(m, HOM_GRID)

    rho_lam = torch.ones(grid.dims, dtype=torch.float64, device="cuda")
    rho_lam[: grid.dims[0] // 2] = 0.25
    Eh_lam, _, it_lam = hom.homogenize(rho_lam, grid, mat, K0, tol=HOM_TOL_LAMINATE,
                                       max_iter=HOM_CAP)
    E = Eh_lam.cpu().numpy()
    C11, C12, G, G_in = laminate_tensor(*mat.lame)
    got = [E[0, 0], E[0, 1], E[0, 2], E[4, 4], E[5, 5], E[3, 3]]
    want = [C11, C12, C12, G, G, G_in]
    rel_b = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    asym = float(np.abs(E - E.T).max())
    print(f"laminate {HOM_GRID}: CG iterations {it_lam.tolist()}; C11, C12, C13, "
          f"G_xz, G_xy, G_yz {got} against the closed form {want}: worst rel {rel_b:.3e}; "
          f"max|Eh - Eh^T| {asym:.3e}")
    check(int(it_lam.max()) < HOM_CAP, f"laminate: CG reached the cap {HOM_CAP}")
    check(rel_b < TOL_BACKUS and asym < TOL_SYMMETRIC,
          f"laminate differs from its closed form: rel {rel_b:.3e}, asymmetry {asym:.3e}")

    g32, m32, K32 = unit_cell(m, HOM_CPU_GRID)
    rng = np.random.default_rng(0)
    r32 = rng.uniform(0.3, 1.0, g32.dims)
    Eh_c, _, it_c = hom.homogenize(torch.tensor(r32, device="cuda"), g32, m32, K32,
                                   tol=HOM_TOL_CPU, max_iter=HOM_CAP)
    t0 = time.perf_counter()
    Eh_h, _, it_h = hom.homogenize(torch.tensor(r32), g32, m32, K32.cpu(), tol=HOM_TOL_CPU,
                                   max_iter=HOM_CAP)
    t_cpu = time.perf_counter() - t0
    err = float((Eh_c.cpu() - Eh_h).abs().max() / Eh_h.abs().max())
    print(f"random cell {HOM_CPU_GRID} tol {HOM_TOL_CPU:g}: Eh card vs CPU rel {err:.3e}; "
          f"CG iterations card {it_c.tolist()}, CPU {it_h.tolist()} (CPU run {t_cpu:.1f} s)")
    check(err <= TOL_HOM_CPU, f"homogenization card vs CPU: rel {err:.3e}")
    d = rng.standard_normal(g32.dims)
    d = torch.tensor(d / np.linalg.norm(d), device="cuda")
    rho0 = torch.tensor(r32, device="cuda")
    _, dEh, _ = hom.homogenize(rho0, g32, m32, K32, tol=FD_TOL, max_iter=HOM_CAP)
    fd = (hom.homogenize(rho0 + FD_H * d, g32, m32, K32, tol=FD_TOL, max_iter=HOM_CAP)[0]
          - hom.homogenize(rho0 - FD_H * d, g32, m32, K32, tol=FD_TOL,
                           max_iter=HOM_CAP)[0]) / (2 * FD_H)
    an = torch.einsum("xyzst,xyz->st", dEh, d)
    fd_err = float((an - fd).abs().max())
    fd_tol = TOL_FD * max(1.0, float(fd.abs().max()))
    print(f"dEh/drho along a random unit direction against a centred difference "
          f"(h {FD_H:g}, tol {FD_TOL:g}): max|d| {fd_err:.3e} (bound {fd_tol:.3e})")
    check(fd_err <= fd_tol, f"homogenized tensor gradient vs FD: {fd_err:.3e}")

    rho64 = torch.tensor(np.random.default_rng(0).uniform(0.3, 1.0, grid.dims),
                         device="cuda")
    launched = m.kernels.launches["apply_k_fine_f64"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    Eh, dEh, iters = hom.homogenize(rho64, grid, mat, K0, tol=HOM_TOL, max_iter=HOM_CAP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_launch = m.kernels.launches["apply_k_fine_f64"] - launched
    check(bool(torch.isfinite(Eh).all() and torch.isfinite(dEh).all())
          and dEh.shape == grid.dims + (6, 6), "homogenization at 64^3: not finite")
    check(int(iters.max()) < HOM_CAP, f"random cell {HOM_GRID}: CG iterations "
                                      f"{iters.tolist()} reached the cap {HOM_CAP}")
    check(n_launch > 0, "homogenization at 64^3 launched no apply_k_fine_f64")
    # where a CG iteration's time goes: a traced window of HOM_TRACE_ITERS
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        hom.solve_cell_problems(rho64, grid, mat, K0, tol=HOM_TOL, max_iter=HOM_TRACE_ITERS)
        torch.cuda.synchronize()
        t_trace = time.perf_counter() - t0
    busy, n_ops, top, port = m.profile_oc.device_summary(prof)
    fine = sum(t for name, t, _ in port)
    line = (f"homogenization float64 random cell {HOM_GRID} tol {HOM_TOL:g}: "
            f"{wall:.4f} s per homogenization (cell solves + Eh + dEh, card "
            f"synchronized), CG iterations per cell problem {iters.tolist()} (cap "
            f"{HOM_CAP}), apply_k_fine_f64 launches {n_launch}, peak {peak:.2f} GiB; "
            f"traced {HOM_TRACE_ITERS} CG iterations: wall {1e3 * t_trace:.1f} ms, device "
            f"busy {1e3 * busy:.1f} ms (fine kernel {1e3 * fine:.1f} ms), {n_ops} device "
            f"ops, idle share {1 - busy / t_trace:.3f}; laminate iterations "
            f"{it_lam.tolist()}, worst rel to Backus {rel_b:.3e}; {HOM_CPU_GRID} card vs "
            f"CPU {err:.3e}")
    print("  top device ops of the traced window:",
          ", ".join(f"{name[:40]} {1e3 * t:.2f} ms x{c}" for name, t, c in top[:6]))
    print(line)
    return line, Eh_lam, grid, mat


def design_path(m, target, grid, mat):
    """Path 17: design_microstructure at 64^3 from rho0 ~ U(0.3, 0.7),
    DESIGN_STEPS Adam steps toward ``target``; returns the summary line."""
    import numpy as np

    rho0 = torch.tensor(np.random.default_rng(1).uniform(0.3, 0.7, grid.dims),
                        device="cuda")
    launched = m.kernels.launches["apply_k_fine_f64"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = m.ms.design_microstructure(target, grid, mat, rho0=rho0, steps=DESIGN_STEPS,
                                     learning_rate=DESIGN_LR, log_every=1)
    torch.cuda.synchronize()
    s_step = (time.perf_counter() - t0) / DESIGN_STEPS
    # each batched CG iteration applies all six fields (a frozen one too),
    # and so does the initial residual: iterations of the longest problem
    cg = (m.kernels.launches["apply_k_fine_f64"] - launched) / (6 * DESIGN_STEPS) - 1
    h = res.history
    check(len(h) == DESIGN_STEPS and all(math.isfinite(x) for x in h) and h[-1] < h[0],
          f"design_microstructure: history {h}")
    check(res.rho.shape == grid.dims and np.isfinite(res.rho).all(), "design: rho")
    line = (f"design_microstructure {grid.dims} float64, {DESIGN_STEPS} Adam steps at lr "
            f"{DESIGN_LR}: {s_step:.4f} s per step, {cg:.1f} CG iterations per step (the "
            f"longest cell problem's), distance {h[0]:.4e} -> {h[-1]:.4e}")
    print(line)
    return line


def cl_run(m, jid: str, extra):
    """One ``train_cl`` CLI run on the bridge at the north star's width:
    every step's compliance finite and positive, cg_iters below the cap,
    the per-task densities (.npy, .vtr) and the history written. Returns
    (the log's (task, step, compliance, cg_iters), the CLI's aux)."""
    argv = ["--prob", BRIDGE, "--grid", json.dumps(list(GRID)), "--v0", "0.4",
            "--mgl", "3", "--es", "1024", "--nn", "512", "--nl", "4", "--log-every", "1",
            "--device", "cuda", "--out", OUT_DIR, "--jid", jid, *extra]
    with captured_stderr() as buf:
        _, histories, aux = m.train_cl.main(argv)
    lines = [(int(t), int(i), float(c), int(n)) for t, i, c, n in CL_RE.findall(buf.getvalue())]
    check(len(lines) == sum(len(h) for h in histories) > 0, f"{jid}: step lines {lines}")
    for t, i, c, n in lines:
        check(math.isfinite(c) and c > 0, f"{jid} task {t} step {i}: compliance {c}")
        check(n < CG_CAP, f"{jid} task {t} step {i}: cg_iters {n} hit the cap {CG_CAP}")
    for t in range(len(histories)):
        for f in (f"_task{t}_densities.npy", f"_task{t}.vtr"):
            check(os.path.exists(os.path.join(OUT_DIR, jid + f)), f"artifact {jid}{f} missing")
    check(os.path.exists(os.path.join(OUT_DIR, f"{jid}_history.json")),
          f"artifact {jid}_history.json missing")
    return lines, aux


def zoo_path(m):
    """Path 19: SIREN (256x3) on a 192x96 coordinate grid, the CNN
    generator and the deconv generator at their default configs, float64:
    forward and the gradient of a random weighting of the output on the
    card against the CPU. Returns the summary line."""
    import copy

    models = m.models
    gen = torch.Generator().manual_seed(0)
    f64 = torch.float64
    coords = m.neural.get_mgrid(ZOO_SIREN_GRID, dtype=f64, device="cpu")
    z = torch.randn(675, 1, generator=gen, dtype=f64)
    cases = (("siren", models.init_siren(models.SirenConfig(), gen, f64, "cpu"),
              lambda mod, dev: models.siren_apply(mod, coords.to(dev))),
             ("cnn", models.init_cnn(models.CNNConfig(), gen, f64, "cpu"),
              lambda mod, dev: models.cnn_apply(mod)),
             ("deconv", models.init_deconv_generator(models.DeconvConfig(), gen, f64, "cpu"),
              lambda mod, dev: models.deconv_generator_apply(mod, z.to(dev))))
    out = []
    for name, model, fwd in cases:
        runs = {}
        for dev in ("cpu", "cuda"):
            mod = copy.deepcopy(model).to(dev)
            t0 = time.perf_counter()
            y = fwd(mod, dev)
            w = torch.randn(y.shape, generator=torch.Generator().manual_seed(1), dtype=f64)
            (y * w.to(dev)).sum().backward()
            if dev == "cuda":
                torch.cuda.synchronize()
            runs[dev] = (y.detach().cpu(), {k: p.grad.cpu() for k, p in mod.named_parameters()},
                         time.perf_counter() - t0)
        (yc, gc, _), (yg, gg, wall) = runs["cpu"], runs["cuda"]
        err_y = float((yg - yc).abs().max() / yc.abs().max())
        err_g = max(float((gg[k] - gc[k]).abs().max() / gc[k].abs().max().clamp_min(1e-300))
                    for k in gc)
        print(f"zoo {name}: output {tuple(yc.shape)}, card vs CPU forward rel {err_y:.3e}, "
              f"gradients worst rel {err_g:.3e}; card forward+backward {wall:.4f} s (first "
              f"call)")
        check(err_y <= TOL_ZOO and err_g <= TOL_ZOO,
              f"zoo {name} card vs CPU: forward {err_y:.3e}, gradients {err_g:.3e}")
        out.append(f"{name} {err_y:.1e}/{err_g:.1e}")
    return "model zoo float64 card vs CPU (forward/gradients): " + ", ".join(out)


def native_io_path(m, density_path: str) -> str:
    """Path 20: the native IO library built from ``native/ndrio.cpp``
    round-trips a classic run's density at GRID through .msh and .vtr
    exactly, and its .vtr reads back equal to the Python writer's (whose
    ASCII .msh takes minutes at this size: the tests hold it byte-equal to
    the JAX package's at small sizes)."""
    import numpy as np

    from ndr_tpu_torch.io import export, native

    rho = np.load(density_path).astype(np.float64)
    grid = m.problem.load_problem(PROB).make_grid(GRID)
    t0 = time.perf_counter()
    lib = native.build()
    t_build = time.perf_counter() - t0
    out = {}
    t0 = time.perf_counter()
    msh = native.write_msh(os.path.join(OUT_DIR, "io.msh"), grid, rho)
    out["msh"] = native.read_msh_field(msh, "density", grid.num_elements).reshape(GRID)
    t_msh = time.perf_counter() - t0
    t0 = time.perf_counter()
    vtr = native.write_vtr(os.path.join(OUT_DIR, "io"), rho, name="density")
    out["vtr"] = export.read_vtr(vtr)["density"]
    t_vtr = time.perf_counter() - t0
    py = native.write_vtr(os.path.join(OUT_DIR, "io_py"), rho, name="density",
                          use_native=False)
    out["python vtr"] = export.read_vtr(py)["density"]
    for k, v in out.items():
        check(v.shape == rho.shape and np.array_equal(v, rho),
              f"native IO: the {k} round trip of the density differs")
    line = (f"native IO ({lib.name}, built or found in {t_build:.2f} s): {GRID} density "
            f"round-trips exactly through .msh ({os.path.getsize(msh) / 1e6:.1f} MB, write "
            f"+ read {t_msh:.2f} s) and .vtr ({t_vtr:.2f} s), equal to the Python "
            f"writer's .vtr")
    print(line)
    return line


def sharded_path(shards):
    """Path 21: ``ground_truth_topopt(shards=...)`` at GRID, mgl=MGL, ITERS
    OC steps on 2 or 4 ranks sharing the card over gloo; every rank's
    launch counters (set to 0 just before its run, read just after) must
    show both fine kernels, and every rank the same history (gathered u,
    replicated OC; 1e-12). Returns
    (every rank's result, s/OC-iter)."""
    from ndr_tpu_torch.parallel import checks, launch

    n = math.prod(shards) if isinstance(shards, tuple) else shards
    results = launch.spawn(checks.sharded_classic, n, device="cuda", backend="gloo",
                           kwargs=dict(shards=shards, prob_path=PROB, dims=GRID,
                                       num_levels=MGL, iters=ITERS),
                           timeout=SHARDED_TIMEOUT)
    res = results[0]
    check(len(res["history"]) == ITERS and all(math.isfinite(c) and c > 0
                                               for c in res["history"]),
          f"sharded {shards}: history {res['history']}")
    check(max(res["cg_iters"]) < CG_CAP, f"sharded {shards}: cg_iters {res['cg_iters']}")
    for r, other in enumerate(results):
        print(f"[sharded {shards} rank {r}] launches {other['launches']}")
        for name in ("apply_k_fine_f32", "apply_k_fine_f64"):
            check(other["launches"][name] > 0,
                  f"sharded {shards}: rank {r} launched no {name}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(other["history"], res["history"]))
        check(rel <= 1e-12, f"sharded {shards}: rank {r}'s history differs from rank "
                            f"0's by {rel:.3e}")
        if rel:
            print(f"[sharded {shards} rank {r}] history {rel:.3e} from rank 0's, not bitwise")
    print(res["log"].splitlines()[0])
    return results, statistics.median(res["step_seconds"][1:])


def entry_grads_rel(grads, ref) -> float:
    """Largest per-leaf relative difference of two gradient dicts (max|d|
    over max|ref|). The last bias's exact gradient is 0 (the constrained
    mean makes the field blind to a shift of the output), so its rounding
    is held against the last weight's gradient instead."""
    names = list(ref)
    rel = 0.0
    for name in names:
        scale = ref[name].abs().max()
        if name == names[-1]:
            scale = ref[names[-2]].abs().max()
        rel = max(rel, float((grads[name] - ref[name]).abs().max() / scale))
    return rel


def entry_path(m):
    """Path 24: ``entry()``'s forward step and gradient on the card and on
    the CPU, with the same parameters (drawn on the CPU from one seed): as
    drawn (a near-uniform first field) and with the last layer's weights
    scaled by 1e3 (a field that varies). Returns the summary line."""
    lines = []
    for scale in (1.0, 1e3):
        out = {}
        for dev in ("cuda", "cpu"):
            forward, (model, coords) = m.dryrun.entry(dev)
            with torch.no_grad():
                model.layers[-1].weight.mul_(scale)
            t0 = time.perf_counter()
            c = forward(model, coords)
            c.backward()
            if dev == "cuda":
                torch.cuda.synchronize()
            grads = {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()}
            out[dev] = (float(c.detach()), time.perf_counter() - t0, grads)
        (c_gpu, t_gpu, g_gpu), (c_cpu, _, g_cpu) = out["cuda"], out["cpu"]
        finite = all(bool(torch.isfinite(g).all()) for g in g_gpu.values())
        rel = abs(c_gpu - c_cpu) / abs(c_cpu)
        rel_g = entry_grads_rel(g_gpu, g_cpu)
        check(math.isfinite(c_gpu) and c_gpu > 0 and finite,
              f"entry() x{scale:g}: compliance {c_gpu}, gradient finite {finite}")
        check(rel <= TOL_ENTRY, f"entry() x{scale:g} card against CPU: rel {rel:.3e} "
              f"> {TOL_ENTRY:g}")
        check(rel_g <= TOL_ENTRY, f"entry() x{scale:g} gradient card against CPU: rel "
              f"{rel_g:.3e} > {TOL_ENTRY:g}")
        lines.append(f"last layer x{scale:g}: compliance {c_gpu:.6f} on the card, "
                     f"{c_cpu:.6f} on the CPU (rel {rel:.3e}), gradients rel {rel_g:.3e}, "
                     f"forward + backward {t_gpu:.3f} s")
    return f"entry() {m.dryrun.ENTRY_DIMS}: " + "; ".join(lines)


def trace_path(m):
    """Path 25: ``timers.trace`` around ``entry()``'s forward step writes a
    Chrome trace that holds device kernels. Returns the summary line."""
    forward, args = m.dryrun.entry("cuda")
    forward(*args)  # the first call builds the solver's state
    with m.timers.trace(os.path.join(OUT_DIR, "trace")) as path:
        forward(*args)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("cat") == "kernel"]
    check(device, f"trace(): {path} holds no device kernel ({len(events)} events)")
    names = {e["name"].split("<")[0].split("(")[0] for e in device}
    return (f"trace(): {os.path.getsize(path)} B, {len(events)} events, {len(device)} "
            f"device kernels ({len(names)} names, e.g. {sorted(names)[:3]})")


def leftovers_path(m):
    """Path 26: the total-volume constraint's gradient (fp32) and the
    Galerkin level stiffnesses (float64) at GRID, mgl=MGL, on the card
    against the CPU. Returns the summary line."""
    import numpy as np

    rho = np.random.default_rng(26).uniform(0.05, 1.0, GRID)
    g = {dev: m.volume.total_volume_constraint_grad(
        torch.tensor(rho, dtype=torch.float32, device=dev), 0.3) for dev in ("cuda", "cpu")}
    check(torch.equal(g["cuda"].cpu(), g["cpu"]), "total_volume_constraint_grad differs")
    kes = {}
    for dev in ("cuda", "cpu"):
        prob, _ = m.simulator.problem_from_config(m.problem.load_problem(PROB), dims=GRID,
                                                  dtype=torch.float64, device=dev)
        kes[dev] = m.mg.build_level_stiffness(m.mg.build_mg_config(prob, MGL),
                                              prob.young(torch.tensor(rho, device=dev)))
    check(len(kes["cuda"]) == MGL, f"build_level_stiffness: {len(kes['cuda'])} levels")
    rels = [errors(a.cpu(), b)[1] for a, b in zip(kes["cuda"], kes["cpu"])]
    check(max(rels) <= TOL_LEVEL_KE, f"build_level_stiffness card against CPU: {rels}")
    return (f"total_volume_constraint_grad {GRID}: equal on card and CPU; "
            f"build_level_stiffness {GRID} mgl={MGL} float64 levels "
            f"{[tuple(k.shape[:3]) for k in kes['cuda']]}: rel to the CPU {rels}")


def reproduce_path(m):
    """Path 27: ``reproduce --only mbb300,c3d_256 --iter 20`` on the card:
    each run's compliances finite, its CG iterations under the cap, its
    JSON record printed. Returns the records."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)), captured_stderr():
        records = m.reproduce.main(["--only", ",".join(REPRO_RUNS), "--iter",
                                    str(REPRO_ITERS), "--device", "cuda", "--out",
                                    os.path.join(OUT_DIR, "reproduce")])
    lines = [json.loads(l) for l in buf.getvalue().strip().splitlines()]
    check([r["jid"] for r in lines] == list(REPRO_RUNS), f"reproduce printed {lines}")
    for r in records:
        check(r["steps"] == REPRO_ITERS, f"reproduce {r['jid']}: {r['steps']} steps")
        for k in ("compliance", "binary_compliance", "last_step_compliance"):
            check(math.isfinite(r[k]) and r[k] > 0, f"reproduce {r['jid']}: {k} {r[k]}")
        cg = r["cg_iters"]
        check(cg["max"] < cg["cap"] and not cg["passes_at_cap"],
              f"reproduce {r['jid']}: cg_iters {cg}")
        # the counts of each run (reproduce sets them to 0 before each)
        for k in ("apply_k_fine_f32", "apply_k_fine_f64", "apply_k_cached_f32"):
            check(r["launches"].get(k, 0) > 0, f"reproduce {r['jid']}: {k} not launched")
    return records


def envelope_path(m):
    """Path 28: the MG envelope sweep at ENVELOPE_GRID, refined, kernels on:
    18 operating points, each mean compliance error within 10 x its tol.
    Returns the rows."""
    rows = m.mg_benchmark.sweep(ENVELOPE_GRID, ENVELOPE_FIELDS, 3, refined=True,
                                use_kernels=True, device="cuda",
                                emit=lambda r: print(json.dumps(r)))
    check(len(rows) == 18, f"mg_benchmark: {len(rows)} operating points")
    for r in rows:
        check(r["c_err_mean"] <= 10 * r["tol"], f"mg_benchmark: {r}")
    return rows


def agree(label: str, a: float, b: float):
    rel = abs(a - b) / abs(b)
    print(f"{label}: {a} vs {b}, rel {rel:.3e}")
    check(rel < TOL_ON_OFF, f"{label} differ: rel {rel:.3e}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False: "
                         "this smoke needs an NVIDIA card")
    m = port_modules()
    m.torch_setup.setup()
    print("== 1. environment")
    phase_environment()
    print("== 2. build")
    phase_build(m)
    print("== 3. kernels against their twins; times at 192x96x96 and 64x32x16")
    worst, records = phase_kernels(m)

    shutil.rmtree(OUT_DIR, ignore_errors=True)
    os.makedirs(OUT_DIR)
    total = {name: 0 for name in m.kernels.launches}
    timings = []
    try:
        print(f"== 4. classic: {PROB} {GRID} mgl={MGL}, {ITERS} OC steps")
        (steps_on, t_on, _), counts, peak = run_path(
            m, "classic on", lambda: classic(m, "on"),
            ("apply_k_fine_f32", "apply_k_cached_f32", "cached_stencil",
             "apply_k_fine_f64"))
        total = {k: total[k] + counts[k] for k in total}
        (steps_off, t_off, _), _, peak_off = run_path(
            m, "classic off", lambda: classic(m, "off"), ())
        agree("classic step-0 compliance on/off", steps_on[0][1], steps_off[0][1])
        timings.append(f"classic {GRID} mgl={MGL}: s/OC-iter on {t_on:.4f} "
                       f"(peak {peak:.2f} GiB), off {t_off:.4f} (peak {peak_off:.2f} GiB)")

        print(f"== 5. neural north star: {BRIDGE} {GRID} mgl=3 "
              f"constrained_sigmoid 1024/512x4, {NEURAL_STEPS} steps")
        star = {}
        for fk, fine32, fine64 in (("variant", "apply_k_fine_elem_f32", "apply_k_fine_f64"),
                                   ("flat32", "apply_k_fine_f32", "apply_k_fine_f64")):
            (lines, s_step, _), counts, peak = run_path(
                m, f"neural {fk}",
                lambda fk=fk: neural(m, f"star_{fk}", GRID, 3, "constrained_sigmoid",
                                     NEURAL_STEPS, ["--fine-kernel", fk]),
                (fine32, "apply_k_cached_f32", "cached_stencil", fine64))
            total = {k: total[k] + counts[k] for k in total}
            star[fk] = lines
            timings.append(f"neural {GRID} mgl=3 fine-kernel {fk}: s/step {s_step:.4f}, "
                           f"peak {peak:.2f} GiB")
        agree("neural step-0 compliance variant/flat32",
              star["variant"][0][1], star["flat32"][0][1])

        print(f"== 6. neural bench config: {BRIDGE} {BENCH_GRID} mgl=2 "
              f"maxed_barrier 1024/512x4")
        (lines_on, s_on, _), counts, peak = run_path(
            m, "bench flat",
            lambda: neural(m, "bench_flat", BENCH_GRID, 2, "maxed_barrier",
                           BENCH_STEPS, ["--fine-kernel", "flat"]),
            ("apply_k_fine_f32", "apply_k_cached_f32", "cached_stencil",
             "apply_k_fine_elem_f64"))
        total = {k: total[k] + counts[k] for k in total}
        (lines_off, s_off, _), _, peak_off = run_path(
            m, "bench off",
            lambda: neural(m, "bench_off", BENCH_GRID, 2, "maxed_barrier", 2,
                           ["--kernels", "off"]), ())
        agree("bench step-0 compliance flat/off", lines_on[0][1], lines_off[0][1])
        timings.append(f"neural {BENCH_GRID} mgl=2 fine-kernel flat: s/step {s_on:.4f} "
                       f"(peak {peak:.2f} GiB); kernels off: s/step {s_off:.4f} "
                       f"(peak {peak_off:.2f} GiB)")

        print(f"== 7. classic GS: {PROB} {GRID} mgl={MGL} --smoother gs, "
              f"{GS_ITERS} OC steps")
        all4 = ("apply_k_fine_f32", "apply_k_cached_f32", "cached_stencil",
                "apply_k_fine_f64")
        (gs_on, t_gs_on, _), counts, peak = run_path(
            m, "classic gs on", lambda: classic(m, "on", "gs", GS_ITERS), all4)
        total = {k: total[k] + counts[k] for k in total}
        (gs_off, t_gs_off, _), _, peak_off = run_path(
            m, "classic gs off", lambda: classic(m, "off", "gs", GS_ITERS), ())
        agree("classic gs step-0 compliance on/off", gs_on[0][1], gs_off[0][1])
        rel = abs(gs_on[0][1] - steps_on[0][1]) / abs(steps_on[0][1])
        print(f"classic step-0 compliance gs/chebyshev: {gs_on[0][1]} vs "
              f"{steps_on[0][1]}, rel {rel:.3e}")
        check(rel < TOL_GS_CHEB, f"classic gs/chebyshev step 0 differ: rel {rel:.3e}")
        timings.append(f"classic gs {GRID} mgl={MGL}: s/OC-iter on {t_gs_on:.4f} "
                       f"(peak {peak:.2f} GiB), off {t_gs_off:.4f} (peak {peak_off:.2f} GiB)")

        print(f"== 8. eval_fourfeat: phase 6's network ({BRIDGE}, maxed_barrier) at "
              f"{[d for d, _ in FOURFEAT_EVALS]}")
        for dims, mgl in FOURFEAT_EVALS:
            argv = ["--prob", BRIDGE, "--checkpoint", os.path.join(OUT_DIR, "bench_flat.npz"),
                    "--grid", json.dumps(list(dims)), "--vcs", "maxed_barrier",
                    "--mgl", str(mgl)]
            (_, _, wall), counts, peak = run_path(
                m, f"eval_fourfeat {dims}",
                lambda argv=argv, dims=dims: evaluation(
                    f"eval_fourfeat {dims} mgl={mgl}", m.eval_fourfeat, argv,
                    "test_resolution", dims), all4)
            total = {k: total[k] + counts[k] for k in total}
            timings.append(f"eval_fourfeat {dims} mgl={mgl}: wall {wall:.2f} s "
                           f"(peak {peak:.2f} GiB)")

        dims, mgl = VOXEL_EVAL
        print(f"== 9. eval_voxelfem: phase 7's final density upsampled to {dims}, mgl={mgl}")
        argv = ["--prob", PROB, "--densities",
                os.path.join(OUT_DIR, "classic_gs_on_densities.npy"),
                "--upsample", json.dumps(list(dims)), "--mgl", str(mgl)]
        (_, _, wall), counts, peak = run_path(
            m, f"eval_voxelfem {dims}",
            lambda: evaluation(f"eval_voxelfem {dims} mgl={mgl}", m.eval_voxelfem, argv,
                               "resolution", dims), all4)
        total = {k: total[k] + counts[k] for k in total}
        timings.append(f"eval_voxelfem {dims} mgl={mgl}: wall {wall:.2f} s "
                       f"(peak {peak:.2f} GiB)")

        print(f"== 10. production classic: {PROB} {PROD_GRID} mgl={PROD_MGL}, "
              f"{PROD_STEPS} OC steps: (a) rebuild every step, (b) --precond-lag "
              f"{PROD_LAG}, (c) --precond-lag {PROD_LAG} --scan {PROD_SCAN}")
        (warm, _, _), counts, _ = run_path(
            m, "production warm-up", lambda: classic(
                m, "on", iters=WARM_STEPS, grid=PROD_GRID, mgl=PROD_MGL,
                jid="production_warm"), ())
        total = {k: total[k] + counts[k] for k in total}
        # the CLI's defaults are ground_truth_topopt's (tol 1e-4, Chebyshev,
        # filters, OC move), the configuration of tests/test_golden.py's check
        head = [c for _, c, _ in warm][:len(C1001_HEAD)]
        rel_c1001 = max(abs(a - b) / abs(b) for a, b in zip(head, C1001_HEAD))
        print(f"production warm-up steps 0-{len(head) - 1} {head} against the reference "
              f"log's C1001_HEAD {C1001_HEAD}: worst rel {rel_c1001:.3e}")
        check(rel_c1001 < TOL_C1001, f"production warm-up differs from the reference log: "
                                     f"rel {rel_c1001:.3e} > {TOL_C1001:g}")
        init = ("--init", os.path.join(OUT_DIR, "production_warm_densities.npy"))
        prod = {}
        for run, extra in (("a", init), ("b", init + ("--precond-lag", str(PROD_LAG))),
                           ("c", init + ("--precond-lag", str(PROD_LAG), "--scan",
                                         str(PROD_SCAN)))):
            (steps, _, res), counts, peak = run_path(
                m, f"production ({run})",
                lambda extra=extra, run=run: classic(
                    m, "on", iters=PROD_STEPS, grid=PROD_GRID, mgl=PROD_MGL,
                    extra=extra, jid=f"production_{run}"),
                ("apply_k_fine_f32", "apply_k_cached_f32", "cached_stencil",
                 "apply_k_fine_f64"))
            total = {k: total[k] + counts[k] for k in total}
            prod[run] = (steps, res, peak)
        hist = {run: [c for _, c, _ in v[0]] for run, v in prod.items()}
        for run in ("b", "c"):
            rel0 = abs(hist[run][0] - hist["a"][0]) / abs(hist["a"][0])
            rel_worst = max(abs(x - y) / abs(y) for x, y in zip(hist[run], hist["a"]))
            print(f"production ({run}) against (a): step 0 rel {rel0:.3e}, "
                  f"worst step rel {rel_worst:.3e}")
            check(rel0 < TOL_STEP0, f"production ({run}) step 0 differs: {rel0:.3e}")
            check(rel_worst < TOL_LAG, f"production ({run}) history differs: {rel_worst:.3e}")
        builds = {run: v[1].solver_stats["hierarchy_builds"] for run, v in prod.items()}
        if builds["b"] == PROD_STEPS // PROD_LAG:  # (b) made no early rebuild
            rel_worst = max(abs(x - y) / abs(y) for x, y in zip(hist["c"], hist["b"]))
            print(f"production (c) against (b): worst step rel {rel_worst:.3e}")
            check(rel_worst < TOL_GRAPH, f"production (c) differs from (b): {rel_worst:.3e}")
        else:
            print(f"production (b) rebuilt early ({builds['b']} builds): (c) not held to it")
        check(builds["c"] == PROD_STEPS // PROD_LAG,
              f"production (c) built the hierarchy {builds['c']} times, "
              f"expected {PROD_STEPS // PROD_LAG}")
        st = prod["c"][1].solver_stats
        check(st["graph_captures"] >= 1 and st["graph_replays"] > 0,
              f"production (c) replayed no CUDA graph: {st}")
        for run, (steps, res, peak) in prod.items():
            mean = statistics.fmean(res.step_seconds)
            line = (f"production ({run}) {PROD_GRID} mgl={PROD_MGL}: s/OC-iter "
                    f"{mean:.4f} (mean of {PROD_STEPS}; median of steps 1-"
                    f"{PROD_STEPS - 1} {statistics.median(res.step_seconds[1:]):.4f}), "
                    f"hierarchy builds {builds[run]}, cg_iters {[n for *_, n in steps]}, "
                    f"peak {peak:.2f} GiB")
            if run == "c":
                line += (f", graph captures {st['graph_captures']}, replays "
                         f"{st['graph_replays']}, capture {st['graph_capture_seconds']:.3f} s")
            timings.append(line)

        print(f"== 11. classic GS under the chunked loop: {GRID} mgl={MGL} --smoother gs "
              f"from the design of {WARM_STEPS} fresh Chebyshev steps: {GS_ITERS} steps "
              f"in the host loop, then {GS_LAG_STEPS} with --precond-lag 4 --scan 4")
        (_, _, _), counts, _ = run_path(
            m, "classic warm-up", lambda: classic(m, "on", iters=WARM_STEPS,
                                                  jid="classic_warm"), ())
        total = {k: total[k] + counts[k] for k in total}
        init = ("--init", os.path.join(OUT_DIR, "classic_warm_densities.npy"))
        (gs_host, t_gs_host, _), counts, _ = run_path(
            m, "classic gs from the warm design",
            lambda: classic(m, "on", "gs", GS_ITERS, extra=init, jid="classic_gs_warm"),
            all4)
        total = {k: total[k] + counts[k] for k in total}
        (gs_lag, _, res), counts, peak = run_path(
            m, "classic gs lag 4 scan 4",
            lambda: classic(m, "on", "gs", GS_LAG_STEPS,
                            extra=init + ("--precond-lag", "4", "--scan", "4"),
                            jid="classic_gs_lag"), all4)
        total = {k: total[k] + counts[k] for k in total}
        st = res.solver_stats
        check(st["graph_replays"] > 0, f"classic gs lag: replayed no CUDA graph: {st}")
        rel_worst = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(gs_lag, gs_host))
        rel0 = abs(gs_lag[0][1] - gs_host[0][1]) / abs(gs_host[0][1])
        print(f"classic gs lag against the host loop: step 0 rel {rel0:.3e}, worst of "
              f"steps 0-{len(gs_host) - 1} rel {rel_worst:.3e}")
        check(rel_worst < TOL_LAG, f"classic gs lag differs from the host loop: {rel_worst:.3e}")
        timings.append(f"classic gs {GRID} mgl={MGL} lag 4 scan 4 from the warm design: "
                       f"s/OC-iter {statistics.fmean(res.step_seconds):.4f} (chunk wall / 4; "
                       f"host loop from the same design {t_gs_host:.4f}, phase 7 {t_gs_on:.4f}), "
                       f"graph captures {st['graph_captures']}, replays {st['graph_replays']}, "
                       f"capture {st['graph_capture_seconds']:.3f} s, peak {peak:.2f} GiB")

        print(f"== 12. neural bench config with --precond-lag 4 --scan 8: {BRIDGE} "
              f"{BENCH_GRID} mgl=2 maxed_barrier 1024/512x4")
        (lines_lag, s_lag, res), counts, peak = run_path(
            m, "bench lag 4 scan 8",
            lambda: neural(m, "bench_lag", BENCH_GRID, 2, "maxed_barrier", BENCH_STEPS,
                           ["--fine-kernel", "flat", "--precond-lag", "4", "--scan", "8"]),
            ("apply_k_fine_f32", "apply_k_cached_f32", "cached_stencil",
             "apply_k_fine_elem_f64"))
        total = {k: total[k] + counts[k] for k in total}
        st = res.solver_stats
        check(st["graph_replays"] > 0, f"bench lag: replayed no CUDA graph: {st}")
        rel_worst = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(lines_lag, lines_on))
        print(f"bench lag against phase 6: worst step rel {rel_worst:.3e}")
        check(rel_worst < TOL_NEURAL_LAG, f"bench lag differs from phase 6: {rel_worst:.3e}")
        timings.append(f"neural {BENCH_GRID} lag 4 scan 8: s/step {s_lag:.4f} (phase 6 "
                       f"{s_on:.4f}), hierarchy builds {st['hierarchy_builds']}, graph "
                       f"captures {st['graph_captures']}, replays {st['graph_replays']}, "
                       f"peak {peak:.2f} GiB")

        print(f"== 13. solver settings: make_mg_solver {PROB} {GRID} mgl={MGL}, "
              "cached_ke_dtype=bfloat16 and lmax_power_iters=8 against the fp32 bound-only "
              "solve")
        (lines13, counts, peak) = run_path(m, "solver settings", lambda: solver_settings(m),
                                           ("apply_k_cached_bf16", "cached_stencil_bf16"))
        total = {k: total[k] + counts[k] for k in total}
        timings.extend(lines13)

        f64_kernels = ("apply_k_fine_f64", "apply_k_cached_f64", "cached_stencil_f64")
        print(f"== 14. classic float64: {PROB} {GRID} mgl={MGL} --x64, {X64_ITERS_ON} OC "
              f"steps kernels on, {X64_ITERS_OFF} off")
        (x64_on, t_x64_on, _), counts, peak = run_path(
            m, "classic x64 on", lambda: classic(m, "on", iters=X64_ITERS_ON, extra=("--x64",),
                                                 jid="classic_x64_on"), f64_kernels)
        total = {k: total[k] + counts[k] for k in total}
        check(counts["apply_k_fine_f32"] == counts["apply_k_cached_f32"] == 0,
              f"classic x64 launched fp32 kernels: {counts}")
        (x64_off, t_x64_off, _), _, peak_off = run_path(
            m, "classic x64 off", lambda: classic(m, "off", iters=X64_ITERS_OFF,
                                                  extra=("--x64",), jid="classic_x64_off"), ())
        rel = abs(x64_on[0][1] - x64_off[0][1]) / abs(x64_off[0][1])
        print(f"classic float64 step-0 compliance on/off: {x64_on[0][1]} vs "
              f"{x64_off[0][1]}, rel {rel:.3e}")
        check(rel <= TOL_X64_ON_OFF, f"classic float64 on/off step 0: rel {rel:.3e}")
        agree("classic float64 step 0 against phase 4's fp32-refined run",
              x64_on[0][1], steps_on[0][1])
        timings.append(f"classic float64 {GRID} mgl={MGL}: s/OC-iter on {t_x64_on:.4f}, "
                       f"cg_iters {[n for *_, n in x64_on]} (peak {peak:.2f} GiB); off "
                       f"{t_x64_off:.4f}, cg_iters {[n for *_, n in x64_off]} "
                       f"(peak {peak_off:.2f} GiB)")

        mbb_grid = MBB_GRID
        print(f"== 15. the reference's 2-D log in float64: {MBB} {mbb_grid} mgl=2 --smoother "
              f"gs --x64, {len(REFERENCE_TRACE) + 1} OC steps")
        (mbb, t_mbb, _), counts, peak = run_path(
            m, "mbb x64 gs", lambda: classic(
                m, "on", "gs", iters=len(REFERENCE_TRACE) + 1, grid=mbb_grid, mgl=2,
                extra=("--x64",), jid="mbb_x64_gs", prob=MBB), f64_kernels)
        total = {k: total[k] + counts[k] for k in total}
        # the compliance before step k is the log's step-k objective
        ours = [c for _, c, _ in mbb][1:len(REFERENCE_TRACE) + 1]
        rel_ref = max(abs(a - b) / abs(b) for a, b in zip(ours, REFERENCE_TRACE))
        print(f"mbb float64 GS steps 1-{len(ours)} {ours} against REFERENCE_TRACE: "
              f"worst rel {rel_ref:.3e}")
        check(rel_ref < TOL_REFERENCE, f"mbb float64 trace differs from the reference log: "
                                       f"rel {rel_ref:.3e} > {TOL_REFERENCE:g}")
        timings.append(f"classic gs float64 {MBB} {mbb_grid} mgl=2: s/OC-iter {t_mbb:.4f}, "
                       f"worst rel to the reference log {rel_ref:.3e} (peak {peak:.2f} GiB)")

        print(f"== 16. neural float64: the bench configuration of phase 6 with --x64, "
              f"{X64_NEURAL_STEPS} steps")
        (lines_x64, s_x64, _), counts, peak = run_path(
            m, "bench x64",
            lambda: neural(m, "bench_x64", BENCH_GRID, 2, "maxed_barrier", X64_NEURAL_STEPS,
                           ["--fine-kernel", "flat", "--x64"]),
            ("apply_k_fine_elem_f64", "apply_k_cached_f64", "cached_stencil_f64"))
        total = {k: total[k] + counts[k] for k in total}
        agree("bench float64 step 0 against phase 6's", lines_x64[0][1], lines_on[0][1])
        timings.append(f"neural float64 {BENCH_GRID} mgl=2 fine-kernel flat: s/step "
                       f"{s_x64:.4f} (phase 6 fp32 {s_on:.4f}), peak {peak:.2f} GiB")

        print(f"== 17. L-BFGS: {PROB} {GRID} mgl={MGL} --optim LBFGS --iter {LBFGS_ITERS}, "
              f"twice; --x64 --iter {LBFGS_X64_ITERS}; --x64 at {LBFGS_SMALL_GRID} on the "
              f"card and on the CPU")
        (line, _), counts, peak = run_path(m, "lbfgs", lambda: lbfgs_path(m),
                                           ("apply_k_fine_f32", "apply_k_cached_f32",
                                            "cached_stencil", "apply_k_fine_f64"))
        total = {k: total[k] + counts[k] for k in total}
        timings.append(line + f", peak {peak:.2f} GiB")

        print(f"== 18. degree 2 ({PROB} {DEGREE2_GRID}, orderFEM [2, 2, 2], "
              f"{DEGREE2_ITERS} OC steps) and the Langelaar filter at {GRID} in float64")
        (d2, t_d2, _), counts, peak = run_path(
            m, "degree 2", lambda: classic(
                m, "auto", iters=DEGREE2_ITERS, grid=DEGREE2_GRID, mgl=MGL,
                jid="degree2", prob=degree2_problem(), cg_cap=DEGREE2_CG_CAP), ())
        check(not any(counts.values()), f"degree 2 launched kernels: {counts}")
        print("degree 2: kernel counters all 0: the CUDA kernels take degree-1 grids, "
              "so --kernels auto takes the plain applies (the JAX package takes XLA there)")
        timings.append(f"classic degree 2 {DEGREE2_GRID}: s/OC-iter {t_d2:.4f}, cg_iters "
                       f"{[n for *_, n in d2]} (block-Jacobi PCG), peak {peak:.2f} GiB")
        timings.append(langelaar(m))

        print(f"== 19. periodic homogenization, float64: the fine kernels at a {HOM_GRID} "
              f"cell; laminate {HOM_GRID}; random {HOM_CPU_GRID} card vs CPU and FD; "
              f"random {HOM_GRID} timed")
        periodic_kernel_checks(m, records, worst)
        (line, Eh_lam, hgrid, hmat), counts, _ = run_path(
            m, "homogenization", lambda: homogenization_path(m), ("apply_k_fine_f64",))
        total = {k: total[k] + counts[k] for k in total}
        timings.append(line)

        print(f"== 20. design_microstructure {HOM_GRID}: {DESIGN_STEPS} Adam steps toward "
              f"the laminate's tensor")
        line, counts, peak = run_path(m, "design", lambda: design_path(m, Eh_lam, hgrid, hmat),
                                      ("apply_k_fine_f64",))
        total = {k: total[k] + counts[k] for k in total}
        timings.append(line + f", peak {peak:.2f} GiB")

        print(f"== 21. train_cl: {BRIDGE} {GRID} mgl=3 1024/512x4, {CL_TASK_END} tasks x "
              f"{CL_ITERS} steps, --gate-rate 0.2 --forget-rate 0.1, kernels on; 1 step off")
        (cl_on, aux_on), counts, peak = run_path(
            m, "train_cl on", lambda: cl_run(
                m, "cl_on", ["--task-interval", "1.5", "--task-end", str(CL_TASK_END),
                             "--iter", str(CL_ITERS), "--gate-rate", "0.2",
                             "--forget-rate", "0.1", "--kernels", "on"]),
            ("apply_k_fine_f32", "apply_k_cached_f32", "cached_stencil", "apply_k_fine_f64"))
        total = {k: total[k] + counts[k] for k in total}
        check(len(cl_on) == CL_TASK_END * CL_ITERS, f"train_cl on: {len(cl_on)} steps")
        (cl_off, _), counts, peak_off = run_path(
            m, "train_cl off", lambda: cl_run(
                m, "cl_off", ["--task-end", "1", "--iter", "1", "--gate-rate", "0.2",
                              "--forget-rate", "0.1", "--kernels", "off"]), ())
        check(not any(counts.values()), f"train_cl --kernels off launched kernels: {counts}")
        agree("train_cl task 0 step-0 compliance on/off", cl_on[0][2], cl_off[0][2])
        per_task = [statistics.median(s[1:]) for s in aux_on["step_seconds"]]
        timings.append(f"train_cl {GRID} mgl=3 1024/512x4 sigmas {aux_on['sigmas']}: s/step "
                       f"per task (median of steps after the first) {per_task}, cg_iters "
                       f"{[n for *_, n in cl_on]}, peak {peak:.2f} GiB; kernels off step 0 "
                       f"{cl_off[0][2]:.6f} (peak {peak_off:.2f} GiB)")
        print(timings[-1])

        print("== 22. the model zoo in float64: card against CPU")
        line, counts, _ = run_path(m, "model zoo", lambda: zoo_path(m), ())
        timings.append(line)

        print(f"== 23. native IO: phase 4's density at {GRID} through .msh and .vtr")
        timings.append(native_io_path(m, os.path.join(OUT_DIR, "classic_on_densities.npy")))

        print(f"== 24. sharded classic: {PROB} {GRID} mgl={MGL}, {ITERS} OC steps, "
              f"2 slabs {LOCAL_SHAPES['slab']} and 2x2 pencils {LOCAL_SHAPES['pencil']}, "
              f"the ranks sharing the card over gloo (host-staged halos)")
        for shards in SHARDS:
            results, s_iter = sharded_path(shards)
            for res in results:
                total = {k: total[k] + res["launches"][k] for k in total}
            res = results[0]
            agree(f"sharded {shards} step-0 compliance against phase 4's unsharded run",
                  res["history"][0], steps_on[0][1])
            halo = "; ".join(f"{k}: {v['exchanges']} exchanges, {v['bytes']} B"
                             for k, v in res["halo_per_apply"].items())
            timings.append(
                f"classic {GRID} mgl={MGL} sharded {shards} ({res['route']}, local "
                f"{tuple(res['local_dims'])}, one card, so code paths, not scaling): "
                f"s/OC-iter {s_iter:.4f} (unsharded, phase 4: {t_on:.4f}), cg_iters "
                f"{res['cg_iters']}, halo per level-0 apply on rank 0: {halo}")
            print(timings[-1])

        print(f"== 25. make_sharded_solver on one rank over NCCL: {GRID} mgl={MGL} "
              f"against the unsharded MGPCG, both refined to {NCCL_SOLVE_TOL:g}")
        from ndr_tpu_torch.parallel import checks, dryrun, launch

        res = launch.spawn(checks.world_one_check, 1, device="cuda", backend="nccl",
                           kwargs=dict(prob_path=PROB, dims=GRID, num_levels=MGL,
                                       tol=NCCL_SOLVE_TOL))[0]
        check(res["route"] == "nccl", f"world size 1: route {res['route']}")
        check(res["rel_diff"] <= TOL_NCCL, f"world size 1 over NCCL against the unsharded "
                                           f"solve: rel {res['rel_diff']:.3e} > {TOL_NCCL:g}")
        timings.append(f"sharded solver, 1 rank over NCCL, {GRID} mgl={MGL} tol "
                       f"{NCCL_SOLVE_TOL:g}: rel diff to the unsharded solve "
                       f"{res['rel_diff']:.3e}; (cg iterations, s) sharded "
                       f"{res['sharded']}, unsharded {res['unsharded']}")
        print(timings[-1])

        print("== 26. dryrun_multichip(2) on the card (2 ranks sharing it over gloo)")
        t0 = time.perf_counter()
        results = dryrun.dryrun_multichip(2, device="cuda", backend="gloo")
        for r, res in enumerate(results):
            print(f"[dryrun rank {r}] launches {res['launches']}")
            check(res["launches"]["apply_k_fine_f32"] > 0
                  and res["launches"]["apply_k_fine_f64"] > 0,
                  f"dryrun rank {r}: the fine kernels were not launched")
            total = {k: total[k] + res["launches"][k] for k in total}
        timings.append(f"dryrun_multichip(2) on the card: compliance "
                       f"{results[0]['compliance']:.6f}, classic 1-D "
                       f"{results[0]['classic 1-D']:.6f}, 2-D {results[0]['classic 2-D']:.6f}, "
                       f"wall {time.perf_counter() - t0:.2f} s")

        fine = ("apply_k_fine_f32", "apply_k_fine_f64")
        print(f"== 27. entry(): the forward step at {m.dryrun.ENTRY_DIMS}, card against CPU")
        line, counts, _ = run_path(m, "entry", lambda: entry_path(m), fine)
        total = {k: total[k] + counts[k] for k in total}
        timings.append(line)
        print(line)

        print("== 28. trace(): entry()'s forward step traced")
        line, counts, _ = run_path(m, "trace", lambda: trace_path(m), fine)
        total = {k: total[k] + counts[k] for k in total}
        timings.append(line)
        print(line)

        print(f"== 29. total_volume_constraint_grad and build_level_stiffness at {GRID}, "
              f"card against CPU")
        timings.append(leftovers_path(m))
        print(timings[-1])

        print(f"== 30. reproduce --only {','.join(REPRO_RUNS)} --iter {REPRO_ITERS}")
        repro, _, _ = run_path(m, "reproduce (its last run)", lambda: reproduce_path(m),
                               fine + ("apply_k_cached_f32", "cached_stencil"))
        for r in repro:
            total = {k: total[k] + r["launches"].get(k, 0) for k in total}
            timings.append(
                f"reproduce {r['jid']} ({REPRO_ITERS} steps): final {r['compliance']:.6f}, "
                f"binary {r['binary_compliance']:.6f}, last step "
                f"{r['last_step_compliance']:.6f}, s/OC-iter (median of steps 1-) "
                f"{r['s_per_step']['median of steps 1-']:.4f}, cg_iters {r['cg_iters']}, "
                f"peak {r['peak_gib']:.2f} GiB, launches {r['launches']}")
            print(timings[-1])

        print(f"== 31. mg_benchmark --fields {ENVELOPE_FIELDS} --refined --kernels on at "
              f"{ENVELOPE_GRID}")
        t0 = time.perf_counter()
        rows, counts, _ = run_path(m, "mg_benchmark", lambda: envelope_path(m),
                                   fine + ("apply_k_cached_f32", "cached_stencil"))
        total = {k: total[k] + counts[k] for k in total}
        loosest = max(rows, key=lambda r: r["c_err_mean"] / r["tol"])
        timings.append(f"mg_benchmark {ENVELOPE_GRID} {ENVELOPE_FIELDS} fields refined: 18 "
                       f"points in {time.perf_counter() - t0:.2f} s, worst c_err / tol "
                       f"{loosest['c_err_mean'] / loosest['tol']:.3e} at {loosest}")
        print(timings[-1])

        print(f"== 32. neural_throughput {THROUGHPUT_STEPS} {THROUGHPUT_CONFIG}")
        res, counts, peak = run_path(
            m, "neural_throughput",
            lambda: m.neural_throughput.measure(THROUGHPUT_CONFIG, THROUGHPUT_STEPS, "cuda"),
            fine + ("apply_k_cached_f32", "cached_stencil"))
        total = {k: total[k] + counts[k] for k in total}
        check(math.isfinite(res["compliance"]) and res["windows"]
              and res["windows"][0]["cg_iters_mean"] < CG_CAP,
              f"neural_throughput: {res}")
        timings.append(f"neural_throughput {THROUGHPUT_CONFIG} {THROUGHPUT_STEPS} steps: "
                       f"{res['it_per_s']:.2f} it/s, window {res['windows']}, "
                       f"peak {peak:.2f} GiB")

        print(f"== 33. validate_2d --dims {','.join(map(str, VALIDATE_DIMS))} --steps "
              f"{VALIDATE_STEPS} --ranks {VALIDATE_RANKS} --backend gloo")
        t0 = time.perf_counter()
        res, counts, _ = run_path(
            m, "validate_2d unsharded",
            lambda: m.validate_2d.validate(VALIDATE_DIMS, VALIDATE_STEPS, 3, VALIDATE_RANKS,
                                           "cuda", "gloo"), fine)
        total = {k: total[k] + counts[k] for k in total}
        for name, run in res["runs"].items():
            if name != "unsharded":  # the ranks' own counts; rank 0's run
                print(f"[validate_2d {name} rank 0] launches {run['launches']}")
                for k in fine:
                    check(run["launches"][k] > 0, f"validate_2d {name}: rank 0 launched no {k}")
                total = {k: total[k] + run["launches"][k] for k in total}
        timings.append(f"validate_2d {VALIDATE_DIMS} {VALIDATE_STEPS} steps, {VALIDATE_RANKS} "
                       f"ranks on one card (gloo): max rel errors {res['errors']}, walls "
                       f"{ {k: round(v['seconds'], 2) for k, v in res['runs'].items()} } s, "
                       f"{time.perf_counter() - t0:.2f} s in all")
        print(timings[-1])
    finally:
        shutil.rmtree(OUT_DIR, ignore_errors=True)

    print("== 34. summary")
    print("launches over the paths:", total)
    for name, n in total.items():
        check(n > 0, f"{name} was launched by no path")
    for line in timings:
        print(line)
    out = []
    main = (f"fine {GRID}", "level 1 (96, 48, 48)")
    for name in ("apply_k_fine_f32", "apply_k_fine_elem_f32", "apply_k_cached_f32",
                 "cached_stencil", "apply_k_fine_f64", "apply_k_fine_elem_f64",
                 "apply_k_cached_bf16", "cached_stencil_bf16", "apply_k_cached_f64",
                 "cached_stencil_f64"):
        src, rep = CACHED[name] if name in CACHED else FINE[name][:2]
        # top level: 192x96x96 (cached kernels: its level 1); "shapes": every
        # timed shape, the bench grid's and level 2 included
        r = next(r for r in records[name] if r["shape"] in main)
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        out.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                    "launches": total[name], "max_abs_err": worst[name],
                    **{k: r[k] for k in keys},
                    "shapes": [{"shape": x["shape"], **{k: x[k] for k in keys}}
                               for x in records[name]]})
    print(json.dumps({"kernels": out}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
