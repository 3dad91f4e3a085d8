"""Process groups for the sharded solver (:mod:`ndr_tpu_torch.parallel.mesh`).

The JAX package shards over the devices of a ``jax.sharding.Mesh`` inside
one program. Here each shard is a process, a rank of a ``torch.distributed``
group, that runs the whole driver on its own device; only the solve talks
to the other ranks.

* :func:`init` joins the group, from ``torchrun``'s environment or from an
  explicit ``init_method`` (e.g. ``file:///path``, a ``FileStore``), and
  maps the rank to its device: the CPU, or card ``local_rank % count``.
* The backend is the caller's choice: ``"nccl"`` where each rank has a card
  of its own, ``"gloo"`` on the CPU and where ranks share a card (gloo has
  no CUDA send/recv, so the mesh stages halos through pinned host memory).
  NCCL refuses two ranks on one card; :func:`init` raises on that case
  rather than switching backends.
* :func:`spawn` starts ``world`` ranks of a function of this package on one
  host (``python -m ndr_tpu_torch.parallel.launch``), over a ``FileStore``
  in a temporary directory, and returns what each rank's call returned. It
  serves the tests and ``chip_smoke.py``; the ranks import only this
  package.
"""

from __future__ import annotations

import datetime
import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, List, Optional, Union

import torch
import torch.distributed as dist

_ROOT = Path(__file__).resolve().parents[2]   # the checkout holding the package


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, local_rank: int, local_world: int, backend: str) -> torch.device:
    """The device of a rank: the CPU, or card ``local_rank % count``. NCCL
    takes one card per rank and raises where ranks would share one."""
    device = torch.device(device)
    if device.type == "cpu":
        if backend == "nccl":
            raise ValueError("the nccl backend takes CUDA devices; use gloo on the CPU")
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but "
                           "torch.cuda.is_available() is False")
    count = torch.cuda.device_count()
    if backend == "nccl" and local_world > count:
        raise ValueError(
            f"nccl takes one card per rank, and {local_world} ranks would share "
            f"{count} card(s): pass backend='gloo' (halos staged through host "
            "memory) or start at most one rank per card")
    return torch.device("cuda", local_rank % count)


def init(backend: Optional[str] = None, device="cuda", init_method: Optional[str] = None,
         rank: Optional[int] = None, world_size: Optional[int] = None,
         timeout: float = 600.0) -> torch.device:
    """Join the default process group and return this rank's device (made
    the current CUDA device). Without ``init_method`` the rank, world size
    and rendezvous come from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``)."""
    backend = backend or default_backend(device)
    env = os.environ
    if init_method is None:
        init_method = "env://"
        rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    dev = rank_device(device, local_rank, local_world, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    return dev


def _target_name(fn: Union[str, Callable]) -> str:
    return fn if isinstance(fn, str) else f"{fn.__module__}:{fn.__qualname__}"


def _resolve(name: str) -> Callable:
    module, _, attr = name.partition(":")
    obj: Any = importlib.import_module(module)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def spawn(fn: Union[str, Callable], world: int, *, device="cpu",
          backend: Optional[str] = None, kwargs: Optional[dict] = None,
          timeout: float = 900.0, threads: Optional[int] = None,
          echo: bool = False) -> List[Any]:
    """Run ``fn(device=..., **kwargs)`` on ``world`` new ranks and return
    the list of their results, by rank (each pickled with ``torch.save``).

    ``fn`` is a function of an importable module (or its
    ``"module:qualname"``). Each rank is ``python -m
    ndr_tpu_torch.parallel.launch`` with the checkout on its
    ``PYTHONPATH``, joins a group over a ``FileStore`` and gets its device
    from :func:`rank_device`; ``threads`` sets each rank's torch threads
    (default: the CPU count over ``world``). A rank that fails ends the
    others and raises with its output; ``echo`` prints rank 0's output
    after a success. Every process started here has ended on return."""
    backend = backend or default_backend(device)
    workdir = tempfile.mkdtemp(prefix="ndr_spawn_")
    procs: List[subprocess.Popen] = []
    logs = []
    try:
        torch.save({"target": _target_name(fn), "backend": backend,
                    "device": str(device), "kwargs": kwargs or {}, "timeout": timeout,
                    "threads": threads or max(1, (os.cpu_count() or 1) // world)},
                   os.path.join(workdir, "args.pt"))
        env = dict(os.environ, LOCAL_WORLD_SIZE=str(world),
                   # the ranks share one host: NCCL's bootstrap needs no other
                   NCCL_SOCKET_IFNAME=os.environ.get("NCCL_SOCKET_IFNAME", "lo"),
                   PYTHONPATH=os.pathsep.join(
                       [str(_ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        for r in range(world):
            log = open(os.path.join(workdir, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ndr_tpu_torch.parallel.launch", workdir,
                 str(r), str(world)],
                env=dict(env, LOCAL_RANK=str(r)), stdout=log, stderr=subprocess.STDOUT,
                cwd=str(_ROOT)))
        deadline = time.monotonic() + timeout + 60
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                r = bad[0] if bad else 0
                for p in procs:
                    p.kill()
                for p in procs:
                    p.wait()
                what = (f"exited with code {procs[r].returncode}" if bad
                        else f"timed out after {timeout:.0f} s")
                raise RuntimeError(f"spawn({_target_name(fn)}, {world}): rank {r} "
                                   f"{what}; its output:\n{_tail(logs[r])}")
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"spawn({_target_name(fn)}, {world}): rank {bad[0]} "
                               f"exited with code {procs[bad[0]].returncode}; its "
                               f"output:\n{_tail(logs[bad[0]])}")
        if echo:
            logs[0].seek(0)
            sys.stdout.write(logs[0].read())
            sys.stdout.flush()
        return [torch.load(os.path.join(workdir, f"result{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(workdir, ignore_errors=True)


def _tail(log, n: int = 12000) -> str:
    log.flush()
    log.seek(0)
    return log.read()[-n:]


def _rank_main(workdir: str, rank: int, world: int) -> None:
    args = torch.load(os.path.join(workdir, "args.pt"), weights_only=False)
    torch.set_num_threads(args["threads"])
    device = init(args["backend"], args["device"],
                  init_method=f"file://{os.path.join(workdir, 'store')}",
                  rank=rank, world_size=world, timeout=args["timeout"])
    try:
        result = _resolve(args["target"])(device=device, **args["kwargs"])
        torch.save(result, os.path.join(workdir, f"result{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
