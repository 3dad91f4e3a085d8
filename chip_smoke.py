"""Smoke run of ndr_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``ndr_tpu_torch/csrc/``, holds
each against its plain PyTorch twin on the card, drives the classic
SIMP-OC path through the ``train_voxelfem`` CLI at 192x96x96 (mgl=3) with
the kernels on and off, and checks that the run went through every
kernel. Any failed phase exits non-zero. The last line of standard output
is one JSON object naming the device.

Imports no JAX: the machine with the card need not have it.
"""

import contextlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

import torch

GRID = (192, 96, 96)
MGL = 3
ITERS = 5
CG_CAP = 100
PROB = "problems/3d/cantilever_flexion.json"
# small shapes of tests/test_pallas.py, then the slice's own
TEST_SHAPES = [("problems/2d/mbb_beam.json", (12, 6)),
               ("problems/3d/cantilever_flexion.json", (8, 4, 4)),
               ("problems/3d/cantilever_flexion.json", (6, 4, 2))]
TOL_F32 = 1e-5      # max|f - f_twin| / max|f_twin|: summation order differs
TOL_F64 = 1e-12
TOL_ON_OFF = 1e-4   # the solver's tolerance; both runs are f64-refined to it


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of fn() in ms from CUDA events, with the L2
    flushed before each launch (the solver finds its operands cold)."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def errors(out, ref):
    diff = float((out.double() - ref.double()).abs().max())
    return diff, diff / float(ref.double().abs().max())


def phase_environment():
    from torch.utils.cpp_extension import CUDA_HOME

    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}")
    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    rel = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    print("nvcc:", [l for l in rel.splitlines() if "release" in l][0].strip())
    print("gpu:", gpu_line())


def phase_build():
    from ndr_tpu_torch.fem import kernels

    seconds = kernels.build()
    print(f"build: {seconds:.2f} s -> {kernels.build_info['path']}")
    for line in str(kernels.build_info["log"]).splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def phase_kernels():
    """Each kernel against its twin at the test shapes and at the slice's
    shapes; returns the JSON records for the slice shapes."""
    import numpy as np

    from ndr_tpu.io.problem import load_problem
    from ndr_tpu_torch.fem import kernels
    from ndr_tpu_torch.fem import multigrid as mg
    from ndr_tpu_torch.fem.simulator import problem_from_config

    dev = torch.device("cuda")
    worst = {"apply_k_fine_f32": 0.0, "apply_k_fine_f64": 0.0,
             "apply_k_cached_f32": 0.0}
    records = {}

    def run(name, kernel, plain, args, grid, tol, nbytes, label, timed):
        out = kernel(*args, grid)
        torch.cuda.synchronize()
        ref = plain(*args, grid)
        abs_err, rel_err = errors(out, ref)
        check(math.isfinite(rel_err) and rel_err < tol,
              f"{name} at {label}: rel err {rel_err:.3e} >= {tol:g}")
        worst[name] = max(worst[name], abs_err)
        line = f"{name:20s} {label:28s} max|d| {abs_err:.3e}  rel {rel_err:.3e}"
        if timed:
            ms = time_ms(lambda: kernel(*args, grid))
            plain_ms = time_ms(lambda: plain(*args, grid))
            gbs = nbytes / (ms * 1e-3) / 1e9
            line += f"  kernel {ms:.4f} ms ({gbs:.1f} GB/s)  plain {plain_ms:.4f} ms"
            records.setdefault(name, []).append(
                dict(shape=label, ms=ms, plain_ms=plain_ms, gbs=gbs))
        print(line)

    rng = np.random.default_rng(0)
    for prob_path, dims in TEST_SHAPES + [(PROB, GRID)]:
        timed = dims == GRID
        prob, grid = problem_from_config(load_problem(prob_path), dims=dims,
                                         device=dev)
        rho = torch.tensor(rng.uniform(1e-3, 1.0, grid.dims), device=dev)
        u = torch.tensor(1e3 * rng.standard_normal(grid.nodes_per_dim + (grid.ndim,)),
                         device=dev)
        young = prob.young(rho)
        nn, ne, N = grid.num_nodes, grid.num_elements, grid.ndim
        args32 = (u.float(), young.float(), prob.K0.float())
        run("apply_k_fine_f32", kernels.apply_k_fine_f32,
            kernels.apply_k_fine_plain, args32, grid, TOL_F32,
            8 * N * nn + 4 * ne, f"fine {dims}", timed)
        run("apply_k_fine_f64", kernels.apply_k_fine_f64,
            kernels.apply_k_fine_plain, (u, young, prob.K0), grid, TOL_F64,
            16 * N * nn + 8 * ne, f"fine {dims}", timed)

        # cached: the Galerkin levels of this grid's hierarchy, built as
        # the solver builds them (level 1 direct, deeper levels recursive)
        nl = MGL if timed else 1
        cfg = mg.build_mg_config(prob, nl)
        ke = mg.build_level_ke(cfg, young.float(), 1)
        for l in range(1, nl + 1):
            if l > 1:
                ke = mg.coarsen_ke(ke, N)
            if l == nl and timed:
                break  # the coarsest level is factored, not applied
            g = cfg.levels[l].grid
            stream = kernels.ke_stream_layout(ke, g)
            ul = torch.tensor(rng.standard_normal(g.nodes_per_dim + (N,)),
                              dtype=torch.float32, device=dev)
            d = g.nodes_per_elem * N
            run("apply_k_cached_f32", kernels.apply_k_cached_f32,
                kernels.apply_k_cached_f32_plain, (ul, stream), g, TOL_F32,
                4 * d * d * g.num_elements + 8 * N * g.num_nodes,
                f"level {l} {g.dims}", timed)
            del stream
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


STEP_RE = re.compile(r"Total Steps: (\d+), Runtime: \S+, Compliance loss (\S+), "
                     r"constraint \S+, lambda \S+, cg_iters (\d+)")


def run_slice(kernels_mode: str, out_dir: str):
    from ndr_tpu_torch.training import train_voxelfem

    buf = io.StringIO()
    argv = ["--prob", PROB, "--grid", json.dumps(list(GRID)), "--mgl", str(MGL),
            "--iter", str(ITERS), "--device", "cuda", "--kernels", kernels_mode,
            "--out", out_dir, "--jid", f"smoke_{kernels_mode}"]
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stderr(_Tee(sys.stderr, buf)):
        result = train_voxelfem.main(argv)
    torch.cuda.synchronize()
    text = buf.getvalue()
    steps = [(int(i), float(c), int(n)) for i, c, n in STEP_RE.findall(text)]
    check([s[0] for s in steps] == list(range(ITERS)),
          f"kernels {kernels_mode}: step lines {steps}")
    for i, c, n in steps:
        check(math.isfinite(c) and c > 0, f"step {i}: compliance {c}")
        check(n < CG_CAP, f"step {i}: cg_iters {n} hit the cap {CG_CAP}")
    check('Compliance loss of binary densities for "' in text
          and "Final step, Compliance loss" in text,
          f"kernels {kernels_mode}: final reference-format lines missing")
    check(math.isfinite(result.compliance) and math.isfinite(result.binary_compliance),
          "final compliance not finite")
    check(result.densities.shape == GRID, f"densities shape {result.densities.shape}")
    for f in (f"smoke_{kernels_mode}.vtr", f"smoke_{kernels_mode}_densities.npy",
              f"smoke_{kernels_mode}_history.json"):
        check(os.path.exists(os.path.join(out_dir, f)), f"artifact {f} missing")
    s_per_iter = statistics.median(result.step_seconds[1:5])
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"kernels {kernels_mode}: compliance by step "
          f"{[c for _, c, _ in steps]}, cg_iters {[n for *_, n in steps]}, "
          f"s/OC-iter (median of steps 1-4) {s_per_iter:.4f}, "
          f"peak memory {peak:.2f} GiB")
    return steps, s_per_iter, peak


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False: "
                         "this smoke needs an NVIDIA card")
    from ndr_tpu_torch.fem import kernels
    from ndr_tpu_torch.utils.torch_setup import setup

    setup()
    print("== 1. environment")
    phase_environment()
    print("== 2. build")
    phase_build()
    print("== 3. kernels against their twins")
    worst, records = phase_kernels()

    out_dir = tempfile.mkdtemp(prefix="ndr_chip_smoke_")
    try:
        print(f"== 4. slice: {PROB} {GRID} mgl={MGL}, {ITERS} OC steps, kernels on")
        kernels.reset_launches()
        steps_on, t_on, peak_on = run_slice("on", out_dir)
        launches = dict(kernels.launches)
        print("launches:", launches)
        for name, n in launches.items():
            check(n > 0, f"{name} was not launched by the main path")

        print("== 5. kernels off (plain torch on the same card)")
        steps_off, t_off, peak_off = run_slice("off", out_dir)
        c_on, c_off = steps_on[0][1], steps_off[0][1]
        rel = abs(c_on - c_off) / abs(c_off)
        print(f"step-0 compliance on {c_on} off {c_off} rel {rel:.3e}")
        check(rel < TOL_ON_OFF, f"kernels on/off step-0 compliance differ {rel:.3e}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    print("== 6. timings")
    print(f"s/OC-iter at {GRID} mgl={MGL}: kernels on {t_on:.4f}, "
          f"off {t_off:.4f} (median of steps 1-4)")
    for name, recs in records.items():
        for r in recs:
            print(f"{name} {r['shape']}: kernel {r['ms']:.4f} ms "
                  f"({r['gbs']:.1f} GB/s), plain {r['plain_ms']:.4f} ms")

    sources = {"apply_k_fine_f32": ("ndr_tpu_torch/csrc/apply_k_fine.cu",
                                    "ndr_tpu/fem/pallas_kernels.py:395"),
               "apply_k_cached_f32": ("ndr_tpu_torch/csrc/apply_k_cached_f32.cu",
                                      "ndr_tpu/fem/pallas_kernels.py:1096"),
               "apply_k_fine_f64": ("ndr_tpu_torch/csrc/apply_k_fine.cu",
                                    "ndr_tpu/fem/pallas_kernels.py:636")}
    out = []
    for name, (src, rep) in sources.items():
        r = records[name][0]  # fine: 192x96x96; cached: level 1
        out.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                    "launches": launches[name], "max_abs_err": worst[name],
                    "ms": r["ms"], "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": out}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
