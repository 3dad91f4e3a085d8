"""Smoke run of ndr_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``ndr_tpu_torch/csrc/`` (one
for each Pallas kernel, and the cached levels' stencil assembly), holds
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
     cantilever's production grid 256x128x128 (mgl=5).

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
    from ndr_tpu_torch.eval import eval_fourfeat, eval_voxelfem
    from ndr_tpu_torch.fem import kernels, multigrid, simulator
    from ndr_tpu_torch.io import problem
    from ndr_tpu_torch.training import train_voxelfem, train_xdg
    from ndr_tpu_torch.utils import torch_setup
    return types.SimpleNamespace(kernels=kernels, mg=multigrid, simulator=simulator,
                                 problem=problem, train_voxelfem=train_voxelfem,
                                 train_xdg=train_xdg, torch_setup=torch_setup,
                                 eval_fourfeat=eval_fourfeat, eval_voxelfem=eval_voxelfem)


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

    def cached(ke, g, label, timed):
        """Assembly and apply of one cached level's stencil."""
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

    rng = np.random.default_rng(0)
    for prob_path, dims in TEST_SHAPES + [(PROB, GRID)]:
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

            def library(args=args, grid=grid):
                ke = args[2]
                S = stencil_from_blocks(kernels, grid, lambda a, c: args[1][..., None, None]
                                        * ke[a * N:(a + 1) * N, c * N:(c + 1) * N],
                                        args[0].dtype)
                K = stencil_csr(kernels, grid, S)
                del S
                return K, args[0].reshape(-1)

            npe = grid.nodes_per_elem
            L = npe.bit_length() - 1
            # operations of the kernels' design, the reflection basis (both
            # types): the two transforms (in 3-D the lower node plane's is
            # carried from the previous element), 2^N N x N blocks, the
            # young scale fused with the carried forces; and of the dense
            # K0 contraction (with the young scale) that it replaced
            dense_flops = ne * (2 * d * d + d)
            flops = ne * (2 * d * L - (d if N == 3 else 0) + 2 * npe * N * N + 2 * d)
            io_bytes = 2 * N * nn * b + ne * b

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
        if not timed:  # a random stack on the grid itself (any shape, coarsenable or not)
            ke = torch.tensor(rng.standard_normal(grid.dims + (d, d)),
                              dtype=torch.float32, device=dev)
            cached(ke, grid, f"random Ke {dims}", False)

        # the Galerkin levels of this grid's hierarchy, built as the solver
        # builds them (level 1 direct, deeper levels recursive); the paths
        # run 192x96x96 with mgl=3 and 64x32x16 with mgl=2
        nl = {GRID: MGL, BENCH_GRID: 2}.get(dims, min(1, m.mg.max_feasible_coarsenings(grid)))
        cfg = m.mg.build_mg_config(prob, nl)
        ke = m.mg.build_level_ke(cfg, young.float(), 1) if nl else None
        for l in range(1, nl + 1):
            if l > 1:
                ke = m.mg.coarsen_ke(ke, N)
            if l == nl and timed:
                break  # the coarsest level is factored, not applied
            g = cfg.levels[l].grid
            cached(ke.contiguous(), g, f"level {l} {g.dims}", timed)
        del ke
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


def classic(m, kernels_mode: str, smoother: str = "chebyshev", iters: int = ITERS):
    jid = f"classic_{kernels_mode}" if smoother == "chebyshev" else \
        f"classic_{smoother}_{kernels_mode}"
    argv = ["--prob", PROB, "--grid", json.dumps(list(GRID)), "--mgl", str(MGL),
            "--iter", str(iters), "--device", "cuda", "--kernels", kernels_mode,
            "--smoother", smoother, "--out", OUT_DIR, "--jid", jid]
    with captured_stderr() as buf:
        result = m.train_voxelfem.main(argv)
    text = buf.getvalue()
    steps = [(int(i), float(c), int(n)) for i, c, n in CLASSIC_RE.findall(text)]
    check([s[0] for s in steps] == list(range(iters)),
          f"{jid}: step lines {steps}")
    for i, c, n in steps:
        check(math.isfinite(c) and c > 0, f"classic step {i}: compliance {c}")
        check(n < CG_CAP, f"classic step {i}: cg_iters {n} hit the cap {CG_CAP}")
    check('Compliance loss of binary densities for "' in text
          and "Final step, Compliance loss" in text,
          f"{jid}: final reference-format lines missing")
    check(math.isfinite(result.compliance) and math.isfinite(result.binary_compliance),
          f"{jid}: final compliance not finite")
    check(result.densities.shape == GRID, f"densities shape {result.densities.shape}")
    for f in (".vtr", "_densities.npy", "_history.json"):
        path = os.path.join(OUT_DIR, f"{jid}{f}")
        check(os.path.exists(path), f"artifact {path} missing")
    s_per_iter = statistics.median(result.step_seconds[1:])
    print(f"{jid}: compliance by step {[c for _, c, _ in steps]}, cg_iters "
          f"{[n for *_, n in steps]}, s/OC-iter (median of steps 1-{iters - 1}) "
          f"{s_per_iter:.4f}")
    return steps, s_per_iter


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
          f"binary {result.binary_compliance:.6f}")
    return lines, s_step


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
        (steps_on, t_on), counts, peak = run_path(
            m, "classic on", lambda: classic(m, "on"),
            ("apply_k_fine_f32", "apply_k_cached_f32", "cached_stencil",
             "apply_k_fine_f64"))
        total = {k: total[k] + counts[k] for k in total}
        (steps_off, t_off), _, peak_off = run_path(
            m, "classic off", lambda: classic(m, "off"), ())
        agree("classic step-0 compliance on/off", steps_on[0][1], steps_off[0][1])
        timings.append(f"classic {GRID} mgl={MGL}: s/OC-iter on {t_on:.4f} "
                       f"(peak {peak:.2f} GiB), off {t_off:.4f} (peak {peak_off:.2f} GiB)")

        print(f"== 5. neural north star: {BRIDGE} {GRID} mgl=3 "
              f"constrained_sigmoid 1024/512x4, {NEURAL_STEPS} steps")
        star = {}
        for fk, fine32, fine64 in (("variant", "apply_k_fine_elem_f32", "apply_k_fine_f64"),
                                   ("flat32", "apply_k_fine_f32", "apply_k_fine_f64")):
            (lines, s_step), counts, peak = run_path(
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
        (lines_on, s_on), counts, peak = run_path(
            m, "bench flat",
            lambda: neural(m, "bench_flat", BENCH_GRID, 2, "maxed_barrier",
                           BENCH_STEPS, ["--fine-kernel", "flat"]),
            ("apply_k_fine_f32", "apply_k_cached_f32", "cached_stencil",
             "apply_k_fine_elem_f64"))
        total = {k: total[k] + counts[k] for k in total}
        (lines_off, s_off), _, peak_off = run_path(
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
        (gs_on, t_gs_on), counts, peak = run_path(
            m, "classic gs on", lambda: classic(m, "on", "gs", GS_ITERS), all4)
        total = {k: total[k] + counts[k] for k in total}
        (gs_off, t_gs_off), _, peak_off = run_path(
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
    finally:
        shutil.rmtree(OUT_DIR, ignore_errors=True)

    print("== 10. summary")
    print("launches over the paths:", total)
    for name, n in total.items():
        check(n > 0, f"{name} was launched by no path")
    for line in timings:
        print(line)
    out = []
    main = (f"fine {GRID}", "level 1 (96, 48, 48)")
    for name in ("apply_k_fine_f32", "apply_k_fine_elem_f32", "apply_k_cached_f32",
                 "cached_stencil", "apply_k_fine_f64", "apply_k_fine_elem_f64"):
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
