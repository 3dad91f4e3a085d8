"""Neural-TO command line (counterpart of ``ndr_tpu/training/train_xdg.py``).

Example:
    python -m ndr_tpu_torch.training.train_xdg --prob problems/3d/bridge.json \\
        --grid "[64, 32, 16]" --v0 0.4 --mgl 2 --sigma 1.0 --iter 100 \\
        --vcs maxed_barrier --jid test

Same flags, log lines and artifacts as the JAX CLI, except: ``--device``
(default cuda) replaces ``--cpu``; ``--kernels auto|on|off`` replaces
``--pallas``; ``--fine-kernel flat32|variant|flat`` replaces the
``NDR_FINE_KERNEL`` environment variable; ``--x64`` runs on the CPU only.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import sys
from typing import List

import numpy as np
import torch

from ndr_tpu_torch.fem import kernels
from ndr_tpu_torch.fem import topopt
from ndr_tpu_torch.io import export
from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.ops.filters import AdaptiveFilterState
from ndr_tpu_torch.training import curriculum
from ndr_tpu_torch.training.neural import (NeuralTOConfig, build_trainer, train,
                                           train_multires)
from ndr_tpu_torch.utils import checkpoint as ckpt
from ndr_tpu_torch.utils.torch_setup import resolve_device, setup


@dataclasses.dataclass
class XDGResult:
    history: List[float]           # compliance of every step
    step_seconds: List[float]      # wall time of every step
    final_compliance: float
    binary_compliance: float
    binary_volume: float
    densities: np.ndarray          # final density field


def main(argv=None) -> XDGResult:
    p = argparse.ArgumentParser()
    p.add_argument("--jid", default=None, help="experiment id for output names")
    p.add_argument("--grid", default=None, help='grid dims e.g. "[40, 20, 10]"')
    p.add_argument("--prob", required=True, help="problem JSON")
    p.add_argument("--v0", default=None, help="volume fraction")
    p.add_argument("--mgl", default=2, type=int, help="multigrid levels")
    p.add_argument("--vcs", default="maxed_barrier", help="volume constraint satisfier")
    p.add_argument("--checkpoint", default=None, help="resume checkpoint path")
    p.add_argument("--es", default=1024, type=int, help="Fourier embedding size")
    p.add_argument("--nn", default=512, type=int, help="hidden width")
    p.add_argument("--nl", default=4, type=int, help="hidden layers")
    p.add_argument("--lr", default=3e-4, type=float)
    p.add_argument("--iter", default=5000, type=int)
    p.add_argument("--cs", default=100, type=int, help="checkpoints per run")
    p.add_argument("--sigma", default=1.0, type=float, help="Fourier feature scale")
    p.add_argument("--out", default="logs/ff")
    p.add_argument("--x64", action="store_true",
                   help="run in float64 end to end (CPU only, plain ops)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; asking for cuda without "
                        "a card raises, it never falls back to the CPU)")
    p.add_argument("--log-every", default=10, type=int)
    p.add_argument("--kernels", default="auto", choices=["auto", "on", "off"],
                   help="hand-written CUDA stiffness kernels in the MG solve "
                        "(auto: on for CUDA tensors; off: plain torch ops)")
    p.add_argument("--fine-kernel", default="flat32", choices=list(kernels.FINE_KERNELS),
                   help="fine-level kernels: flat32 (default: the streamed "
                        "apply in fp32 and for the f64 residual), variant "
                        "(element-centric fp32 apply), flat (element-centric "
                        "float64 residual)")
    p.add_argument("--smoother", default="chebyshev", choices=["chebyshev", "gs"],
                   help="MG smoother: chebyshev or gs (multicolor Gauss-Seidel)")
    p.add_argument("--cheb-degree", default=2, type=int,
                   help="Chebyshev polynomial degree per smoothing iteration")
    p.add_argument("--mlp-precision", default=None,
                   choices=["default", "high", "highest"],
                   help="hidden-layer matmul precision of the MLP "
                        "(default: NeuralTOConfig's)")
    p.add_argument("--scan", default=0, type=int,
                   help="device-side chunked loop (not ported yet)")
    p.add_argument("--precond-lag", default=0, type=int,
                   help="rebuild the MG hierarchy every N steps (not ported yet)")
    # multiresolution curriculum
    p.add_argument("--res-interval", default=0, type=int,
                   help="grid-size delta between multires resolutions")
    p.add_argument("--res-start", default=0, type=int)
    p.add_argument("--res-end", default=1, type=int)
    p.add_argument("--res-order", default="ftc", choices=["ctf", "ftc", "random"])
    p.add_argument("--repeat-res", default=1, type=int)
    p.add_argument("--epoch-mode", default="constant",
                   choices=["constant", "linear_inc", "linear_dec",
                            "linear_abs", "random"],
                   help="per-resolution iteration schedule (constant uses --iter)")
    p.add_argument("--epoch-start", default=800, type=int)
    p.add_argument("--epoch-end", default=1500, type=int)
    # adaptive filtering: "off", "auto" (the problem JSON's
    # adaptive_filtering list [beta_interval, beta_scaler, radius_interval,
    # radius_scaler, sigma_interval, sigma_scaler]) or a JSON dict of
    # AdaptiveFilterState fields
    p.add_argument("--af", default="off",
                   help='adaptive filtering: "off", "auto", or a JSON dict')
    args = p.parse_args(argv)

    setup()
    device = resolve_device(args.device)
    if args.x64 and device.type != "cpu":
        raise NotImplementedError(
            "--x64 on CUDA: the fp32 kernels take no float64 and no float64 "
            "cached kernel is ported yet (ROADMAP.md Queue 2 item 6); use "
            "--device cpu")
    dtype = torch.float64 if args.x64 else torch.float32

    cfg = load_problem(args.prob)
    if args.v0 is not None:
        cfg = dataclasses.replace(cfg, max_volume=float(args.v0))
    dims = tuple(ast.literal_eval(args.grid)) if args.grid else cfg.grid_dims

    ncfg = NeuralTOConfig(
        embedding_size=args.es, n_neurons=args.nn, n_layers=args.nl,
        sigma=args.sigma, learning_rate=args.lr,
        volume_constraint_satisfier=args.vcs,
        multigrid_levels=args.mgl, seed=cfg.seed,
        use_kernels={"auto": "auto", "on": True, "off": False}[args.kernels],
        fine_kernel=args.fine_kernel,
        smoother=args.smoother,
        cheb_degree=args.cheb_degree,
        precond_lag=args.precond_lag,
        **({"matmul_precision": args.mlp_precision}
           if args.mlp_precision else {}),
    )

    rng = np.random.default_rng(cfg.seed)
    os.makedirs(args.out, exist_ok=True)
    title = args.jid or f"{cfg.name}_s{args.sigma}"

    filters = None
    filters_init = {}
    if args.af == "auto" and cfg.adaptive_filtering:
        af = list(cfg.adaptive_filtering) + [1.0] * 6
        filters = AdaptiveFilterState(
            use_projection=True, beta_interval=af[0], beta_scaler=af[1],
            use_smoothing=True, radius_interval=af[2], radius_scaler=af[3],
            use_gaussian=False, sigma_interval=af[4], sigma_scaler=af[5],
        )
    elif args.af not in ("off", "auto"):
        fields = json.loads(args.af)
        filters = AdaptiveFilterState(**fields)
        filters_init = {k: v for k, v in fields.items()
                        if k in ("beta", "radius", "sigma")}
    if filters is not None:
        sys.stderr.write(f"adaptive filtering configs: {filters}\n")

    ckp_step = max(args.iter // args.cs, 1)
    saver = ckpt.AsyncCheckpointer()

    def checkpoint_cb(i, state):
        if (i + 1) % ckp_step == 0:
            saver.save(os.path.join(args.out, f"{title}_iter{i}.npz"),
                       state.model, ncfg.sigma, step=state.step,
                       optimizer=state.optimizer)

    resume_state = None
    if args.checkpoint:
        resume_state, _, _ = build_trainer(cfg, ncfg, dims=dims, dtype=dtype,
                                           device=device)
        sigma, step = ckpt.load_checkpoint(args.checkpoint, resume_state.model,
                                           resume_state.optimizer)
        resume_state.step = int(step or 0)
        sys.stderr.write(f"Resumed checkpoint at step {step} (sigma={sigma})\n")

    multires = args.res_interval != 0 or args.res_end > 1 or args.repeat_res > 1
    try:
        if multires:
            if resume_state is not None:
                raise SystemExit("--checkpoint resume is single-resolution only")
            deltas = curriculum.prepare_resolutions(
                interval=args.res_interval, start=args.res_start,
                end=args.res_end, order=args.res_order,
                repeat_res=args.repeat_res, generator=rng,
            )
            if args.res_order == "ftc":
                deltas = deltas[:-1]  # the reference drops the tail
            epoch_sizes = curriculum.prepare_epoch_sizes(
                n_resolutions=len(deltas), start=args.epoch_start,
                end=args.epoch_end, mode=args.epoch_mode,
                constant_value=args.iter, generator=rng,
            )
            state, history, aux = train_multires(
                cfg, ncfg, dims, deltas, epoch_sizes,
                log_every=args.log_every, filters=filters,
                filters_init=filters_init, checkpoint_cb=checkpoint_cb,
                dtype=dtype, device=device, scan_chunk=args.scan,
            )
        else:
            state, history, aux = train(
                cfg, ncfg, dims=dims, max_iter=args.iter,
                log_every=args.log_every, checkpoint_cb=checkpoint_cb,
                state=resume_state, filters=filters, dtype=dtype,
                device=device, scan_chunk=args.scan,
            )
    finally:
        saver.wait()

    # final artifacts: density field, final checkpoint, history
    with torch.no_grad():
        rho_t = aux["density_fn"](state.model, aux["coords"], aux["max_volume"])
    rho = rho_t.cpu().numpy()
    np.save(os.path.join(args.out, f"{title}_densities.npy"), rho)
    grid = aux["grid"]
    export.write_vtr(
        os.path.join(args.out, title), {"density": rho},
        spacing=tuple(grid.stretchings) + (1.0,) * (3 - grid.ndim),
    )
    ckpt.save_checkpoint(os.path.join(args.out, f"{title}.npz"), state.model,
                         ncfg.sigma, step=state.step, optimizer=state.optimizer)

    # final compliance and thresholded binary compliance, one solve each
    prob, solve = aux["prob"], aux["solve"]
    state.u = None  # free the warm-start field before two cold solves
    with torch.no_grad():
        u, _ = solve(rho_t, None)
        c_final = float(2.0 * topopt.compliance_with_adjoint(rho_t, u, prob))
        binary = (rho_t > 0.5).to(dtype)
        b_vol = float(torch.mean(binary))
        u, _ = solve(binary, None)
        c_binary = float(2.0 * topopt.compliance_with_adjoint(binary, u, prob))
    sys.stderr.write(
        f"Final compliance {c_final:.6f}, binary {c_binary:.6f}, "
        f"b-vol={b_vol:.7f}\n"
    )
    with open(os.path.join(args.out, f"{title}_history.json"), "w") as f:
        json.dump({
            "history": history,
            "final_compliance": c_final,
            "binary_compliance": c_binary,
            "step_seconds": aux["step_seconds"],
        }, f)
    return XDGResult(history=history, step_seconds=aux["step_seconds"],
                     final_compliance=c_final, binary_compliance=c_binary,
                     binary_volume=b_vol, densities=rho)


if __name__ == "__main__":
    main()
