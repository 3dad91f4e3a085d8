"""The readings the limits of ``correct`` are set from, on the card at a
cell's own size: the program's (the lower readings) and the control's,
the reference put in the program's place one precision down (the upper
readings). The benchmark's own runs never run this.

    python3 benchmark/control.py --workload <cell> --program-seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 5 [--out FILE]

Classic cells: each seed runs the program for a short window; the control
answers the same kept steps from the program's designs (float32 solve
with no float64 refinement and TF32 element products, float32 update).
Neural cells: each program seed runs the program's first chunk; each
control seed follows the reference's three steps with fp8 layer products
and reads them against the float32 reference, and also reads what a
state left unchanged would give. One JSON line per reading.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness.program import Context  # noqa: E402
from benchmark.harness.spec import Spec  # noqa: E402


def classic_control(config, ev, device):
    import torch

    from benchmark.reference import classic as ref, fem
    from benchmark.reference.precision import tf32_matmul

    prob = fem.build_problem(config, device=device)
    prob32 = prob.to(torch.float32)
    f, o, s = config["filters"], config["optimizer"], config["solver"]
    worst = {}
    for _, (x, _, _) in ev.steps():
        u, x_next = ref.control_step(prob32, x, s["tol"], s["cg_iter"], f["smoothing_radius"],
                                     f["projection_beta"], o["move"], o["ctol"], tf32_matmul)
        got = ref.judge_step(prob, x, u, x_next, f["smoothing_radius"], f["projection_beta"],
                             o["move"])
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    spec = Spec()
    cell = spec.cell(args.workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    driver = spec.driver(config["driver"])
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    neural = config["driver"] == "neural"
    # a neural program seed needs only its first chunk: a one-chunk window
    for who, seed in ([("program", s) for s in seeds(args.program_seeds)]
                      + [("control", s) for s in seeds(args.control_seeds)]):
        t = time.perf_counter()
        rec = {"cell": args.workload, "who": who, "seed": seed}
        if who == "control" and neural:
            from benchmark.reference.precision import fp8_linear

            ref = driver.reference(config, seed, args.device)
            ctl = driver.reference(config, seed, args.device, linear=fp8_linear)
            rec["readings"] = driver.compare(driver.Observed.of_trajectory(ctl), ref)
            still = driver.Observed(
                [ref.losses[0]] * len(ref.losses), ref.first_grads, ref.params[0], ref.params[0])
            rec["unchanged_state"] = driver.compare(still, ref)
            rec["reference_cg"] = ref.cg_iters
        else:
            ctx = Context(config, traffic, seed, args.seconds, False, time.perf_counter(),
                          args.device)
            sess, ev = driver.run(ctx)
            del sess
            gc.collect()
            torch.cuda.empty_cache()
            if neural:
                traj = driver.reference(config, seed, args.device)
                rec["readings"] = driver.compare(driver.Observed.of_program(ev), traj)
                rec["reference_cg"] = traj.cg_iters
                rec["reference_residual"] = traj.residuals
            else:
                rec["readings"] = driver.readings(config, ev, seed, args.device)
                if who == "control":
                    rec["program"] = rec.pop("readings")
                    rec["readings"] = classic_control(config, ev, args.device)
        rec["seconds"] = time.perf_counter() - t
        emit(rec)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
