"""Where the time of a neural-TO training step goes on the card: the
``train_xdg`` trainer (``training/neural.py``) at one configuration.

    python -m ndr_tpu_torch.utils.profile_neural \\
        [--prob problems/3d/bridge.json] [--grid "[192,96,96]"] [--mgl 3] \\
        [--vcs constrained_sigmoid] [--es 1024 --nn 512 --nl 4] \\
        [--steps 3] [--fine-kernel flat32] [--kernels on]

It runs ``2 + steps + 1`` training steps on CUDA, as
``utils/profile_oc.py`` does for the OC step: two warm-up steps; ``steps``
steps with the card synchronized around each section of :data:`SECTIONS`
(the chunked MLP forward, the volume satisfier with its ``find_root``
bisection, the whole MGPCG solve, the backward pass — which recomputes
the MLP chunks — and the Adam step); then one step traced with
``torch.profiler`` without those syncs (wall, device busy time, idle
share, device ops, the ops that took the most time).
"""

from __future__ import annotations

import argparse
import ast
from collections import defaultdict

import torch

from ndr_tpu_torch.fem import multigrid as mg
from ndr_tpu_torch.io.problem import load_problem
from ndr_tpu_torch.models import mlp
from ndr_tpu_torch.ops import volume as vol
from ndr_tpu_torch.training import neural
from ndr_tpu_torch.utils.profile_oc import WARMUP, report, synced_sections
from ndr_tpu_torch.utils.torch_setup import resolve_device, setup

#: (label, owner, attribute) of each synchronized section.
SECTIONS = (
    ("MLP forward (chunked)", mlp, "mlp_apply_chunked"),
    ("volume satisfier (find_root)", vol, "satisfy_volume_constraint"),
    ("solve total", mg, "mgpcg_solve"),
    ("backward (MLP recompute + grads)", torch.Tensor, "backward"),
    ("Adam step", torch.optim.Adam, "step"),
)


def profile(cfg, ncfg: neural.NeuralTOConfig, dims, steps: int, device):
    tag = f"[{ncfg.fine_kernel}, kernels {ncfg.use_kernels}]"
    on, seconds, calls = [False], defaultdict(float), defaultdict(int)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
    traced = WARMUP + steps

    def callback(idx, state):
        # runs after step idx: switch the timing mode of step idx + 1
        on[0] = WARMUP - 1 <= idx < traced - 1
        if idx == traced - 1:
            torch.cuda.synchronize()
            prof.start()
        elif idx == traced:
            torch.cuda.synchronize()
            prof.stop()

    torch.cuda.reset_peak_memory_stats()
    with synced_sections(on, seconds, calls, SECTIONS):
        _, _, aux = neural.train(cfg, ncfg, dims=dims, max_iter=traced + 1,
                                 checkpoint_cb=callback, device=device,
                                 log=lambda s: None)
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_seconds = aux["step_seconds"]
    report(tag, "s/step", SECTIONS, seconds, calls, steps,
           step_seconds[WARMUP:traced], step_seconds[traced], prof)
    print(f"{tag} peak memory {peak:.2f} GiB")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--prob", default="problems/3d/bridge.json")
    p.add_argument("--grid", default="[192,96,96]")
    p.add_argument("--mgl", default=3, type=int)
    p.add_argument("--vcs", default="constrained_sigmoid")
    p.add_argument("--es", default=1024, type=int)
    p.add_argument("--nn", default=512, type=int)
    p.add_argument("--nl", default=4, type=int)
    p.add_argument("--steps", default=3, type=int)
    p.add_argument("--fine-kernel", default="flat32")
    p.add_argument("--kernels", default="on", choices=["on", "off"])
    args = p.parse_args(argv)

    setup()
    device = resolve_device("cuda")
    cfg = load_problem(args.prob)
    dims = tuple(ast.literal_eval(args.grid))
    ncfg = neural.NeuralTOConfig(
        embedding_size=args.es, n_neurons=args.nn, n_layers=args.nl,
        volume_constraint_satisfier=args.vcs, multigrid_levels=args.mgl,
        seed=cfg.seed, use_kernels=args.kernels == "on",
        fine_kernel=args.fine_kernel)
    print(f"profile_neural: {args.prob} {dims} mgl={args.mgl} {args.vcs} "
          f"{args.es}/{args.nn}x{args.nl}")
    profile(cfg, ncfg, dims, args.steps, device)


if __name__ == "__main__":
    main()
