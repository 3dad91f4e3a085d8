"""Domain decomposition of the voxel grid over the ranks of a
``torch.distributed`` group (counterpart of ``ndr_tpu/parallel/mesh.py``).

The JAX package shards the grid over a device mesh under ``shard_map``;
here every shard is a rank (:mod:`ndr_tpu_torch.parallel.launch`) and the
collectives translate one for one:

* ``ppermute`` of a plane -> ``batch_isend_irecv`` with the neighbours that
  exist (an edge rank sends nothing where JAX discards the wrapped message);
* ``psum`` -> ``all_reduce``; ``all_gather`` -> ``all_gather``.

The decomposition is the JAX package's: **ghost-element replication**.
Each rank owns a block of elements and the nodes around it, so the node
planes on a block face are held by both neighbours. A local stiffness
apply then needs only a halo sum of those planes' forces
(:func:`halo_sum_forces`), or, overlapped, the neighbours' input planes
ahead of the local apply (:func:`halo_overlap_apply`); transfers,
smoothers and dot products follow the same pattern, so the whole MGPCG
runs with communication only at block faces and one all-gathered coarsest
level, solved replicated on every rank.

Two decompositions, one implementation: 1-D slabs along x
(:class:`ShardedGrid`, a mesh of shape ``(n,)``) and 2-D pencils along x
and y (:class:`ShardedGrid2D`, ``(nx, ny)``, rank = ix * ny + iy). A face
exchange along y after one along x completes the corner nodes
transitively, as in JAX. The 2-D names of the JAX module
(:func:`halo_sum_forces_2d`, :func:`sync_halo_2d`, :func:`psum_vdot_2d`,
:func:`restrict_sharded_2d`, the ``_2d`` shard helpers) are the same
functions.

On each rank the fine level applies through ``kernels.fine_kernels``'s
pair on the rank's local grid (slab ``(L, ny, nz)``, pencil
``(Lx, Ly, nz)``): the fp32 apply in the CG and the smoother, the float64
apply for the refinement's residual, as JAX calls ``apply_k_pallas_fine``
and ``apply_k_pallas_df_fine``. The one-element strips of the overlapped
apply and the local Galerkin levels stay torch ops, as in JAX
(``ops.apply_k`` / ``ops.apply_k_cached`` on a per-element Ke).

Differences from JAX, each for a reason: the 2-D solver's refinement
residual also runs through the float64 kernel (JAX's takes XLA there);
the coarsest solve takes the unsharded solver's rule (Newton-Schulz up to
``multigrid.NS_AUTO_MAX_DOFS`` fp32 DoFs, else Cholesky; JAX's sharded
solver always takes Newton-Schulz in fp32, whose ~30 dense products cost
seconds per build at a 12,675-DoF coarsest level); the power iteration's
start vector comes from a generator seeded with 7, not
``jax.random.PRNGKey(7)``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ndr_tpu_torch.fem import kernels
from ndr_tpu_torch.fem import multigrid as mg
from ndr_tpu_torch.fem import operators as ops
from ndr_tpu_torch.fem import solvers
from ndr_tpu_torch.fem.simulator import FEMProblem
from ndr_tpu_torch.grid import Grid
from ndr_tpu_torch.utils import timers


# ---------------------------------------------------------------------------
# Decompositions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedGrid:
    """The slab decomposition: the global grid's leading element dim split
    into ``num_shards`` equal slabs (it must divide evenly). Each shard
    stores ``local_elems + 1`` node planes, the last shared with the next
    shard."""

    global_grid: Grid
    num_shards: int

    def __post_init__(self):
        if self.global_grid.dims[0] % self.num_shards:
            raise ValueError(f"leading dim {self.global_grid.dims[0]} not divisible by "
                             f"{self.num_shards} shards")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.num_shards,)

    @property
    def local_elems(self) -> int:
        return self.global_grid.dims[0] // self.num_shards

    @property
    def local_dims(self) -> Tuple[int, ...]:
        return (self.local_elems,) + tuple(self.global_grid.dims[1:])

    @property
    def local_grid(self) -> Grid:
        return self.global_grid.with_dims(self.local_dims)


@dataclasses.dataclass(frozen=True)
class ShardedGrid2D:
    """The pencil decomposition: the two leading element dims split into
    (shards_x, shards_y) equal pencils, each stored with the boundary node
    planes it shares along both sharded axes."""

    global_grid: Grid
    shards_x: int
    shards_y: int

    def __post_init__(self):
        gd = self.global_grid.dims
        if gd[0] % self.shards_x or gd[1] % self.shards_y:
            raise ValueError(f"dims {gd[:2]} not divisible by ({self.shards_x}, "
                             f"{self.shards_y}) shards")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.shards_x, self.shards_y)

    @property
    def local_dims(self) -> Tuple[int, ...]:
        gd = self.global_grid.dims
        return (gd[0] // self.shards_x, gd[1] // self.shards_y) + tuple(gd[2:])

    @property
    def local_grid(self) -> Grid:
        return self.global_grid.with_dims(self.local_dims)


def _block(coords, sizes, overlap: int) -> tuple:
    """The slices of one shard's block: ``sizes`` elements (or node
    spacings) per sharded axis, plus ``overlap`` = 1 shared node plane."""
    return tuple(slice(c * n, (c + 1) * n + overlap) for c, n in zip(coords, sizes))


def node_block(u, sg, coords):
    """The node block of the shard at mesh ``coords`` of a global node
    field (of ``sg.global_grid``; a contiguous copy for a tensor)."""
    d = sg.global_grid.degree
    out = u[_block(coords, [n * d for n in sg.local_dims[:len(sg.shape)]], 1)]
    return out.contiguous().clone() if isinstance(out, torch.Tensor) else out


def elem_block(e: torch.Tensor, sg, coords) -> torch.Tensor:
    """The element block of the shard at mesh ``coords`` (a contiguous
    copy)."""
    return e[_block(coords, sg.local_dims[:len(sg.shape)], 0)].contiguous().clone()


def shard_node_field(u: torch.Tensor, sg) -> torch.Tensor:
    """Every shard's node block, stacked over the mesh: ``(n, L*d+1,
    rest..., N)`` for slabs, ``(nx, ny, Lx*d+1, Ly*d+1, rest..., N)`` for
    pencils; the shared boundary planes are replicated."""
    blocks = [node_block(u, sg, c) for c in np.ndindex(*sg.shape)]
    return torch.stack(blocks).reshape(sg.shape + blocks[0].shape)


def unshard_node_field(blocks: torch.Tensor, sg) -> torch.Tensor:
    """Inverse of :func:`shard_node_field` (drops the duplicated planes)."""
    return _assemble([blocks[c] for c in np.ndindex(*sg.shape)], sg.shape, overlap=True)


def shard_elem_field(e: torch.Tensor, sg) -> torch.Tensor:
    """Every shard's element block (no overlap), stacked over the mesh."""
    blocks = [elem_block(e, sg, c) for c in np.ndindex(*sg.shape)]
    return torch.stack(blocks).reshape(sg.shape + blocks[0].shape)


def _assemble(blocks: Sequence[torch.Tensor], shape, overlap: bool) -> torch.Tensor:
    """The global field of per-shard blocks given in mesh order; with
    ``overlap`` a block past the first along a sharded axis drops its
    first (duplicated) plane there."""
    trimmed = []
    for c, b in zip(np.ndindex(*shape), blocks):
        for ax, ci in enumerate(c):
            if overlap and ci > 0:
                b = b.narrow(ax, 1, b.shape[ax] - 1)
        trimmed.append(b)
    if len(shape) == 1:
        return torch.cat(trimmed, 0)
    ny = shape[1]
    return torch.cat([torch.cat(trimmed[i * ny:(i + 1) * ny], 1)
                      for i in range(shape[0])], 0)


shard_node_field_2d = shard_node_field
unshard_node_field_2d = unshard_node_field
shard_elem_field_2d = shard_elem_field


# ---------------------------------------------------------------------------
# The ranks as a mesh
# ---------------------------------------------------------------------------

class Mesh:
    """This rank's place in a mesh of the ranks of the default process
    group: shape ``(n,)`` for slabs or ``(nx, ny)`` for pencils, rank =
    ix * ny + iy.
    Without an initialized group a mesh of one rank runs every collective
    as the identity.

    Routes: ``nccl`` (device tensors throughout), ``gloo`` on the CPU, and
    ``gloo, host-staged`` where gloo serves ranks on a card (it has no
    CUDA send/recv: halos go through pinned host buffers, reductions and
    gathers through host copies). :attr:`stats` counts the halo exchanges,
    the bytes this rank sent in them, all-reduces and all-gathers."""

    def __init__(self, shape: Sequence[int], device):
        self.shape = tuple(int(s) for s in shape)
        self.size = math.prod(self.shape)
        self.device = torch.device(device)
        if dist.is_available() and dist.is_initialized():
            world, rank = dist.get_world_size(), dist.get_rank()
            self.backend = dist.get_backend()
        else:
            world, rank, self.backend = 1, 0, None
        if world != self.size:
            raise ValueError(f"a {self.shape} mesh needs {self.size} ranks; the process "
                             f"group has {world} (start them with torchrun or "
                             "parallel.launch.spawn)")
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("the nccl backend takes CUDA tensors")
        self.rank = rank
        self.coords = tuple(int(c) for c in np.unravel_index(rank, self.shape))
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.stats = {"exchanges": 0, "halo_bytes": 0, "all_reduces": 0,
                      "all_gathers": 0}

    @property
    def route(self) -> str:
        if self.backend is None:
            return "local (one rank, no process group)"
        return f"{self.backend}, host-staged" if self.staged else self.backend

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = 0

    def peer(self, axis: int, step: int) -> Optional[int]:
        """The rank of the neighbour ``step`` away along mesh ``axis``, or
        None past the mesh's edge."""
        c = list(self.coords)
        c[axis] += step
        if not 0 <= c[axis] < self.shape[axis]:
            return None
        return int(np.ravel_multi_index(c, self.shape))

    def start_exchange(self, axis: int, to_lo: Optional[List[torch.Tensor]],
                       to_hi: Optional[List[torch.Tensor]]) -> "_Exchange":
        """Send ``to_lo`` to the lower neighbour along mesh ``axis`` and
        ``to_hi`` to the upper one, and receive theirs (each list packed
        into one message of one dtype; every shard's block has the same
        shape, so what comes from below has the shapes of ``to_hi``). A
        direction given as None is sent by no rank. Returns a handle whose
        ``wait()`` gives ``(from_lo, from_hi)``, None where nothing
        comes."""
        lo, hi = self.peer(axis, -1), self.peer(axis, 1)
        ex = _Exchange(self, to_hi if lo is not None else None,
                       to_lo if hi is not None else None)
        p2p = []
        for peer, send in ((lo, to_lo), (hi, to_hi)):
            if peer is None or send is None:
                continue
            flat = torch.cat([t.reshape(-1) for t in send])
            if self.staged:
                host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
                host.copy_(flat)
                flat = host
            ex.sends.append(flat)
            p2p.append(dist.P2POp(dist.isend, flat, peer))
            self.stats["halo_bytes"] += flat.numel() * flat.element_size()
        for side, (peer, like) in enumerate(((lo, to_hi), (hi, to_lo))):
            if peer is None or like is None:
                continue
            recv = torch.empty(sum(t.numel() for t in like), dtype=like[0].dtype,
                               device="cpu" if self.staged else like[0].device,
                               pin_memory=self.staged)
            ex.recv[side] = recv
            p2p.append(dist.P2POp(dist.irecv, recv, peer))
        if p2p:
            self.stats["exchanges"] += 1
            ex.works = dist.batch_isend_irecv(p2p)
        return ex

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group (a new tensor on t's device)."""
        if self.backend is None:
            return t
        self.stats["all_reduces"] += 1
        out = t.detach().to("cpu", copy=True) if self.staged else t.detach().clone()
        dist.all_reduce(out)
        return out.to(t.device) if self.staged else out

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (equal shapes), in rank order."""
        if self.backend is None:
            return [t]
        self.stats["all_gathers"] += 1
        src = t.detach().to("cpu") if self.staged else t.detach()
        src = src.contiguous()
        if self.backend == "nccl":
            out = torch.empty((self.size,) + tuple(src.shape), dtype=src.dtype,
                              device=src.device)
            dist.all_gather_into_tensor(out, src)
            parts = list(out.unbind(0))
        else:
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src)
        return [p.to(t.device) for p in parts] if self.staged else parts


class _Exchange:
    """A halo exchange in flight (:meth:`Mesh.start_exchange`); holds its
    send buffers until :meth:`wait`."""

    def __init__(self, mesh: Mesh, like_lo, like_hi):
        self.mesh, self.like = mesh, (like_lo, like_hi)
        self.recv: List[Optional[torch.Tensor]] = [None, None]
        self.sends: List[torch.Tensor] = []
        self.works = []

    def wait(self):
        for w in self.works:
            w.wait()
        self.sends.clear()
        out = []
        for recv, like in zip(self.recv, self.like):
            if recv is None:
                out.append(None)
                continue
            if self.mesh.staged:
                recv = recv.to(self.mesh.device, non_blocking=True)
            parts, k = [], 0
            for t in like:
                parts.append(recv[k:k + t.numel()].view(t.shape))
                k += t.numel()
            out.append(parts)
        return tuple(out)


def make_mesh(n: int, device="cuda") -> Mesh:
    """The slab mesh of the ``n`` ranks of the process group."""
    return Mesh((n,), device)


def make_mesh_2d(shards_x: int, shards_y: int, device="cuda") -> Mesh:
    """The pencil mesh of the ``shards_x * shards_y`` ranks of the group."""
    return Mesh((shards_x, shards_y), device)


# ---------------------------------------------------------------------------
# Halos, dot products, transfers
# ---------------------------------------------------------------------------

def _plane(ax: int, i: int) -> tuple:
    return (slice(None),) * ax + (i,)


def _halo_sum_axis(f: torch.Tensor, ax: int, mesh: Mesh) -> torch.Tensor:
    """Complete the duplicated first/last planes of ``f`` along array axis
    ``ax`` = mesh axis ``ax``: each adds its neighbour's partial sum. In
    place; returns ``f``."""
    if mesh.shape[ax] == 1:
        return f
    from_lo, from_hi = mesh.start_exchange(ax, [f[_plane(ax, 0)]],
                                           [f[_plane(ax, -1)]]).wait()
    if from_lo is not None:
        f[_plane(ax, 0)] += from_lo[0]
    if from_hi is not None:
        f[_plane(ax, -1)] += from_hi[0]
    return f


def _sync_halo_axis(u: torch.Tensor, ax: int, mesh: Mesh) -> torch.Tensor:
    """Make the duplicated planes along axis ``ax`` consistent, the lower
    shard owning them: each first plane takes its lower neighbour's last.
    In place; returns ``u``."""
    if mesh.shape[ax] == 1:
        return u
    from_lo, _ = mesh.start_exchange(ax, None, [u[_plane(ax, -1)]]).wait()
    if from_lo is not None:
        u[_plane(ax, 0)] = from_lo[0]
    return u


def halo_sum_forces(f: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """After a local apply the block-face node planes hold partial sums;
    one exchange per sharded axis (x, then y) completes them, corners
    transitively. In place; returns ``f``."""
    for ax in range(len(mesh.shape)):
        f = _halo_sum_axis(f, ax, mesh)
    return f


def sync_halo_displacements(u: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Owner-consistent duplicated planes along every sharded axis (owner:
    the lower shard). In place; returns ``u``."""
    for ax in range(len(mesh.shape)):
        u = _sync_halo_axis(u, ax, mesh)
    return u


halo_sum_forces_2d = halo_sum_forces
sync_halo_2d = sync_halo_displacements


def halo_overlap_apply(u_local, p_first, p_last, apply_full, apply_strip,
                       mesh: Mesh) -> torch.Tensor:
    """Stiffness apply with the x halo exchange overlapped with compute.

    The exchange ships apply *inputs*, ready at entry: one u node plane
    and one operator element plane (young or Ke, ``p_first`` /
    ``p_last``, shape ``(1, rest...)``) each way. The messages are posted
    before the local ``apply_full(u_local)`` and waited for after it; then
    each rank recomputes its two boundary element strips itself
    (``apply_strip(u2, p)`` on 2 node planes), the contributions the
    neighbour would have shipped. Equal to
    ``halo_sum_forces(apply_full(u_local))`` along mesh axis 0 (x)."""
    pending = mesh.start_exchange(0, [u_local[1], p_first], [u_local[-2], p_last])
    f = apply_full(u_local)
    from_lo, from_hi = pending.wait()
    if from_lo is not None:
        u_l, p_l = from_lo
        f[0] += apply_strip(torch.stack([u_l, u_local[0]]), p_l)[1]
    if from_hi is not None:
        u_r, p_r = from_hi
        f[-1] += apply_strip(torch.stack([u_local[-1], u_r]), p_r)[0]
    return f


def _halo_sum_past_x(f: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The force sums along the sharded axes after x (pencils: y)."""
    for ax in range(1, len(mesh.shape)):
        f = _halo_sum_axis(f, ax, mesh)
    return f


def make_sharded_apply_k(sg, K0: torch.Tensor, mesh: Mesh, overlap: bool = True):
    """Per-shard stiffness apply ``(u_local, young_local) -> f_local``:
    local matrix-free apply + halo completion (overlapped input exchange
    along x by default)."""
    local_grid = sg.local_grid
    strip_grid = local_grid.with_dims((1,) + local_grid.dims[1:])

    def apply_k_shard(u_local, young_local):
        K0t = K0.to(u_local.dtype)
        if not overlap:
            return halo_sum_forces(ops.apply_k(u_local, young_local, K0t, local_grid),
                                   mesh)
        f = halo_overlap_apply(
            u_local, young_local[:1], young_local[-1:],
            lambda u: ops.apply_k(u, young_local, K0t, local_grid),
            lambda u2, p: ops.apply_k(u2, p, K0t, strip_grid), mesh)
        return _halo_sum_past_x(f, mesh)

    return apply_k_shard


def psum_vdot(a: torch.Tensor, b: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Global dot product over the shards, each duplicated plane counted
    once (by its owner, the lower shard); a 0-d tensor, equal on every
    rank."""
    if mesh.coords[0] > 0:
        a, b = a[1:], b[1:]
    local = torch.dot(a.reshape(-1), b.reshape(-1))
    if len(mesh.coords) > 1 and mesh.coords[1] > 0:
        local = local - torch.dot(a[:, 0].reshape(-1), b[:, 0].reshape(-1))
    return mesh.all_reduce(local)


psum_vdot_2d = psum_vdot


def restrict_sharded(r_local: torch.Tensor, ndim: int, mesh: Mesh) -> torch.Tensor:
    """Sharded residual restriction: the local [1/2, 1, 1/2]^N stencil with
    each duplicated first plane's even term counted only by its owner,
    then a halo sum to complete the coarse boundary planes."""
    if any(mesh.coords):
        r_local = r_local.clone()
        for ax, c in enumerate(mesh.coords):
            if c > 0:
                r_local[_plane(ax, 0)] = 0.0
    return halo_sum_forces(mg.restrict(r_local, ndim), mesh)


restrict_sharded_2d = restrict_sharded


def prolong_sharded(u_coarse_local: torch.Tensor, ndim: int) -> torch.Tensor:
    """Sharded prolongation: local (consistent replicated boundary planes
    stay consistent under interpolation)."""
    return mg.prolongate(u_coarse_local, ndim)


# ---------------------------------------------------------------------------
# Sharded block-Jacobi CG
# ---------------------------------------------------------------------------

def make_sharded_cg(sg, prob: FEMProblem, mesh: Mesh, tol: float, max_iter: int):
    """Block-Jacobi-preconditioned CG over the sharded domain:
    ``solve(u0_l, young_l, b_l, dmask_l) -> (x_l, iterations)``."""
    local_grid = sg.local_grid
    apply_shard = make_sharded_apply_k(sg, prob.K0, mesh)

    def solve(u0_l, young_l, b_l, dmask_l):
        def zero_d(v):
            return v.masked_fill(dmask_l, 0.0)

        def A(v):
            return zero_d(apply_shard(zero_d(v), young_l))

        blocks = halo_sum_forces(
            ops.node_diag_blocks(young_l, prob.K0.to(young_l.dtype), local_grid), mesh)
        inv = ops.invert_blocks(blocks)

        def precond(r):
            return zero_d((inv * r.unsqueeze(-2)).sum(-1))

        return solvers.conjugate_gradient(A, zero_d(b_l), zero_d(u0_l), tol=tol,
                                          max_iter=max_iter, precond=precond,
                                          dot=functools.partial(psum_vdot, mesh=mesh))

    return solve


# ---------------------------------------------------------------------------
# Sharded geometric multigrid (full MGPCG over slabs or pencils)
# ---------------------------------------------------------------------------
#
# Every multigrid ingredient maps onto the decomposition with face-plane
# communication only: Galerkin coarsening is element-local; prolongation
# is local; restriction is local but for the shared coarse planes (one
# halo sum); the Chebyshev smoother is a polynomial in D^-1 K, so the
# sharded apply and a halo-summed block diagonal make it SPMD (the
# multicolor GS sweep is not shardable without plane-sequential sweeps, so
# the sharded solver always smooths with Chebyshev, as in JAX); the
# coarsest level is all-gathered and solved densely on every rank.

@dataclasses.dataclass
class _Level:
    grid: Grid                         # local grid
    mask: torch.Tensor                 # local Dirichlet mask
    apply: object
    Dinv: torch.Tensor
    lmax: float
    Ke: Optional[torch.Tensor]         # cached levels

    def zero(self, u):
        return u.masked_fill(self.mask, 0.0)

    def dinv(self, r):
        return self.zero((self.Dinv * r.unsqueeze(-2)).sum(-1))


def gather_field(mesh: Mesh, x_l: torch.Tensor, overlap: bool) -> torch.Tensor:
    """The global field of every rank's block ``x_l`` (all-gathered, so on
    every rank); ``overlap``: node blocks, whose shared planes are kept
    once."""
    return _assemble(mesh.all_gather(x_l), mesh.shape, overlap)


def _make_sharded_mgpcg(sg, prob: FEMProblem, num_levels: int, mesh: Mesh, tol: float,
                        max_iter: int, mg_smoothing_iterations: int, cheb_degree: int,
                        coarse_shift: Optional[float], lmax_power_iters: int,
                        mixed_precision: bool, use_kernels: bool, max_refinements: int):
    if tuple(sg.shape) != mesh.shape:
        raise ValueError(f"decomposition {sg.shape} on a mesh of shape {mesh.shape}")
    grid0 = sg.global_grid
    ndim = grid0.ndim
    nsh = len(sg.shape)
    local = sg.local_dims[:nsh]
    if any(n % (1 << num_levels) for n in local):
        raise ValueError(f"local block {local} not divisible by 2^{num_levels}")
    if num_levels < 1:
        raise ValueError("the sharded solver needs at least one coarse level")
    if use_kernels and grid0.degree != 1:
        raise ValueError(f"use_kernels on degree-{grid0.degree} elements: the CUDA "
                         "kernels take degree-1 grids")
    device = mesh.device
    # the fine pair of the JAX package's default NDR_FINE_KERNEL=flat32
    fine32, fine64 = kernels.fine_kernels("flat32") if use_kernels else (None, None)

    level_grids = [grid0]
    level_masks = [prob.dirichlet_mask.cpu().numpy()]
    for _ in range(num_levels):
        level_grids.append(level_grids[-1].coarsened())
        level_masks.append(mg.coarsen_dirichlet_mask(level_masks[-1]))
    local_grids = [g.with_dims(tuple(n // s for n, s in zip(g.dims[:nsh], sg.shape))
                               + tuple(g.dims[nsh:])) for g in level_grids]
    local_masks = [torch.as_tensor(node_block(mk, type(sg)(g, *sg.shape), mesh.coords),
                                   device=device).contiguous()
                   for g, mk in zip(level_grids, level_masks)]
    K0_np = prob.K0.cpu().numpy()
    c_stacks = {l: mg.deep_coarsened_k0s(K0_np, ndim, l) for l in range(1, num_levels + 1)}
    lmax_bounds = {0: mg._pencil_lmax_bound(K0_np, ndim)}
    for l in range(1, num_levels + 1):
        lmax_bounds[l] = mg._pencil_lmax_bound(c_stacks[l], ndim)
    coarse_mask = torch.as_tensor(level_masks[-1].reshape(-1), device=device)
    dot = functools.partial(psum_vdot, mesh=mesh)
    K0_by_dtype = {}

    def K0_of(dtype):
        # one tensor per dtype for the whole solve: the fine kernels keep
        # K0's blocks in constant memory, keyed by the tensor object
        if dtype not in K0_by_dtype:
            K0_by_dtype[dtype] = prob.K0.to(device=device, dtype=dtype).contiguous()
        return K0_by_dtype[dtype]

    def fine_apply(young, lg, kernel):
        """Level-0 apply on the local grid: the kernel (or ops.apply_k) on
        the block, torch-op strips, then the halo sums past x."""
        K0t = K0_of(young.dtype)
        strip = lg.with_dims((1,) + lg.dims[1:])
        full = ((lambda v: kernel(v, young, K0t, lg)) if kernel is not None
                else (lambda v: ops.apply_k(v, young, K0t, lg)))

        def apply(u):
            f = halo_overlap_apply(u, young[:1], young[-1:], full,
                                   lambda u2, p: ops.apply_k(u2, p, K0t, strip), mesh)
            return _halo_sum_past_x(f, mesh)
        return apply

    def cached_apply(Ke, lg):
        strip = lg.with_dims((1,) + lg.dims[1:])

        def apply(u):
            f = halo_overlap_apply(u, Ke[:1], Ke[-1:],
                                   lambda v: ops.apply_k_cached(v, Ke, lg),
                                   lambda u2, p: ops.apply_k_cached(u2, p, strip), mesh)
            return _halo_sum_past_x(f, mesh)
        return apply

    def build_levels(rho_l) -> List[_Level]:
        young = ops.element_young_modulus(rho_l, prob.E0, prob.Emin, prob.gamma)
        f64 = young.dtype == torch.float64
        levels = []
        for l in range(num_levels + 1):
            lg = local_grids[l]
            if l == 0:
                Ke = None
                blocks = ops.node_diag_blocks(young, K0_of(young.dtype), lg)
                apply_l = fine_apply(young, lg, fine64 if f64 else fine32)
            else:
                C = torch.as_tensor(c_stacks[l], dtype=young.dtype, device=device)
                pooled = mg.pooled_young(young, l)
                R, d = C.shape[0], C.shape[-1]
                Ke = (pooled.reshape(-1, R) @ C.reshape(R, d * d)).reshape(
                    pooled.shape[:-1] + (d, d))
                blocks = ops.node_diag_blocks_cached(Ke, lg)
                apply_l = cached_apply(Ke, lg)
            lv = _Level(grid=lg, mask=local_masks[l], apply=apply_l,
                        Dinv=ops.invert_blocks(halo_sum_forces(blocks, mesh)),
                        lmax=lmax_bounds[l], Ke=Ke)
            if lmax_power_iters > 0:
                # inflated power estimate, min'ed with the guaranteed bound;
                # the seeded start vector's shared planes made consistent
                gen = torch.Generator(device=device).manual_seed(7)
                v = sync_halo_displacements(lv.zero(torch.randn(
                    lg.nodes_per_dim + (ndim,), generator=gen, dtype=young.dtype,
                    device=device)), mesh)
                est = (1.2 / 1.05) * timers.read(mg.power_lmax(
                    lv.apply, lv.dinv, lv.zero, v, lmax_power_iters, dot=dot))
                lv.lmax = min(lv.lmax, est)
            levels.append(lv)
        return levels

    def factor_coarse(levels):
        """All-gather the coarsest Ke and factor the dense global coarse K
        on every rank (replicated)."""
        Ke_full = gather_field(mesh, levels[-1].Ke, overlap=False)
        K = ops.pin_dirichlet(solvers.assemble_dense_k_traced(Ke_full, level_grids[-1]),
                              coarse_mask)
        fp32 = K.dtype == torch.float32
        ndofs = level_grids[-1].num_nodes * ndim
        method = "ns" if fp32 and ndofs <= mg.NS_AUTO_MAX_DOFS else "cholesky"
        if not fp32:
            eps = 1e-12
        elif coarse_shift is not None:
            eps = coarse_shift
        else:
            eps = 1e-5 if method == "ns" else 1e-4
        diag = K.diagonal()
        diag.add_(eps * diag)
        if method == "ns":
            return ("ns", mg.ns_inverse(K))
        return ("chol", torch.linalg.cholesky(K))

    def coarse_solve(coarse, b_l):
        kind, data = coarse
        b_full = gather_field(mesh, b_l, overlap=True)
        rhs = b_full.reshape(-1).masked_fill(coarse_mask, 0.0)
        if kind == "ns":
            x = data @ rhs
        else:
            x = torch.cholesky_solve(rhs[:, None], data)[:, 0]
        return node_block(x.reshape(b_full.shape), type(sg)(level_grids[-1], *sg.shape),
                          mesh.coords)

    def smooth(lv, x, b, x_is_zero=False, need_r=False):
        # chain the smoother's residual between sweeps and into the
        # V-cycle's restriction (one halo'd apply saved per hand-off)
        r = None
        for k in range(mg_smoothing_iterations):
            last = k == mg_smoothing_iterations - 1
            x, r = mg.chebyshev_core(lv.apply, lv.dinv, lv.zero, lv.lmax, x, b, cheb_degree,
                                     x_is_zero=x_is_zero and k == 0,
                                     need_r=need_r or not last, r0=r)
        return x, r

    def vcycle(levels, coarse, l, x, b, x_is_zero=False):
        if l == num_levels:
            return coarse_solve(coarse, b)
        x, r = smooth(levels[l], x, b, x_is_zero=x_is_zero, need_r=True)
        r_c = levels[l + 1].zero(restrict_sharded(r, ndim, mesh))
        e_c = vcycle(levels, coarse, l + 1, torch.zeros_like(r_c), r_c, x_is_zero=True)
        x = x + levels[l].zero(prolong_sharded(e_c, ndim))
        x, _ = smooth(levels[l], x, b)
        return x

    def cg(levels, coarse, u0, b, tol_):
        """MGPCG on built levels, relative tolerance ``tol_``."""
        lv0 = levels[0]

        def A(v):
            return lv0.zero(lv0.apply(lv0.zero(v)))

        def precond(r):
            return lv0.zero(vcycle(levels, coarse, 0, torch.zeros_like(r), r,
                                   x_is_zero=True))

        return solvers.conjugate_gradient(A, lv0.zero(b), lv0.zero(u0), tol=tol_,
                                          max_iter=max_iter, precond=precond, dot=dot)

    def solve(u0_l, rho_l, b_l):
        levels = build_levels(rho_l)
        return cg(levels, factor_coarse(levels), u0_l, b_l, tol)

    def level0_apply(young):
        """The halo-completed level-0 apply on this rank's block of
        ``young`` (through the kernel of young's dtype with kernels on)."""
        return fine_apply(young, local_grids[0],
                          fine64 if young.dtype == torch.float64 else fine32)

    solve.build_levels = build_levels
    solve.level0_apply = level0_apply
    if not mixed_precision:
        return solve

    # float64 iterative refinement around the fp32 sharded MGPCG: the true
    # residual in float64 per shard + halo sums, fp32 correction solves
    f32, f64 = torch.float32, torch.float64
    lg0 = local_grids[0]
    fp32_floor = 5e-4

    def solve_refined(u0_l, rho_l, b_l):
        levels = build_levels(rho_l.to(f32))
        coarse = factor_coarse(levels)
        zero64 = levels[0].zero
        young64 = ops.element_young_modulus(rho_l.to(f64), prob.E0, prob.Emin, prob.gamma)
        b64 = zero64(b_l.to(f64))
        apply64 = fine_apply(young64, lg0, fine64)

        def residual64(u):
            return zero64(b64 - apply64(u))

        b_norm = float(torch.sqrt(psum_vdot(b64, b64, mesh)))
        u = zero64(u0_l.to(f64))
        r = residual64(u)
        total, done, k = 0, False, 0
        while not done and k < max_refinements:
            rn = max(math.sqrt(float(psum_vdot(r, r, mesh))), 1e-300)
            needed = tol * b_norm / rn
            inner_tol = float(np.float32(np.clip(0.5 * needed, fp32_floor, 0.9)))
            e32, iters = cg(levels, coarse, torch.zeros(r.shape, dtype=f32, device=device),
                            r.to(f32), inner_tol)
            u = u + e32.to(f64)
            done = 0.5 * needed >= fp32_floor
            if not done:
                r = residual64(u)
            total += iters
            k += 1
        return u, total

    solve_refined.build_levels = build_levels
    solve_refined.level0_apply = level0_apply
    return solve_refined


def make_sharded_mgpcg(sg: ShardedGrid, prob: FEMProblem, num_levels: int, mesh: Mesh,
                       tol: float = 1e-4, max_iter: int = 100,
                       mg_smoothing_iterations: int = 2, cheb_degree: int = 2,
                       coarse_shift: Optional[float] = None, lmax_power_iters: int = 8,
                       mixed_precision: bool = False, use_kernels: bool = False,
                       max_refinements: int = 6):
    """Sharded MGPCG over the slab decomposition:
    ``solve(u0_l, rho_l, b_l) -> (x_l, cg iterations)`` on this rank's
    node slabs ``(L+1, rest_nodes..., N)`` and element slab
    ``(L, rest...)``. The local element count must be divisible by
    2^num_levels.

    ``mixed_precision``: float64 iterative refinement around the fp32
    MGPCG (the true residual in float64 per shard + halo sum, fp32
    correction solves, float64 accumulation; u0/b in float64).
    ``use_kernels``: the fine level through ``kernels.fine_kernels("flat32")``
    (their plain twins on CPU tensors).
    ``coarse_shift``: the fp32 coarsest level's relative diagonal shift
    (default 1e-5 under Newton-Schulz, as JAX's, 1e-4 under Cholesky, as
    the unsharded solver's; float64 takes 1e-12)."""
    if not isinstance(sg, ShardedGrid):
        raise TypeError("make_sharded_mgpcg takes a ShardedGrid (pencils: "
                        "make_sharded_mgpcg_2d)")
    return _make_sharded_mgpcg(sg, prob, num_levels, mesh, tol, max_iter,
                               mg_smoothing_iterations, cheb_degree, coarse_shift,
                               lmax_power_iters, mixed_precision, use_kernels,
                               max_refinements)


def make_sharded_mgpcg_2d(sg: ShardedGrid2D, prob: FEMProblem, num_levels: int,
                          mesh: Mesh, tol: float = 1e-4, max_iter: int = 100,
                          mg_smoothing_iterations: int = 2, cheb_degree: int = 2,
                          coarse_shift: Optional[float] = None,
                          mixed_precision: bool = False, use_kernels: bool = False,
                          max_refinements: int = 6):
    """Sharded MGPCG over the pencil decomposition: the solver of
    :func:`make_sharded_mgpcg` with the x exchange overlapped and the y
    exchange a force sum (which completes the x strips' corners), and
    lambda_max the guaranteed pencil bound alone, as in JAX. The local
    element counts along x and y must divide by 2^num_levels."""
    if not isinstance(sg, ShardedGrid2D):
        raise TypeError("make_sharded_mgpcg_2d takes a ShardedGrid2D")
    return _make_sharded_mgpcg(sg, prob, num_levels, mesh, tol, max_iter,
                               mg_smoothing_iterations, cheb_degree, coarse_shift, 0,
                               mixed_precision, use_kernels, max_refinements)


# ---------------------------------------------------------------------------
# Driver integration: a global-field SolveFn
# ---------------------------------------------------------------------------

def _global_solver(prob: FEMProblem, sg, mesh: Mesh, make, num_levels, tol, max_iter,
                   mg_smoothing_iterations, cheb_degree, mixed_precision, use_kernels):
    use = mg.resolve_use_kernels(use_kernels, prob.device, sg.local_grid)
    mixed = mixed_precision and prob.force.dtype == torch.float32
    solve_shard = make(sg, prob, num_levels, mesh, tol=tol, max_iter=max_iter,
                       mg_smoothing_iterations=mg_smoothing_iterations,
                       cheb_degree=cheb_degree, mixed_precision=mixed, use_kernels=use)
    def solve(rho, u0=None):
        b = prob.force.masked_fill(prob.dirichlet_mask, 0.0)
        if mixed:
            b = b.to(torch.float64)
        u0 = torch.zeros_like(b) if u0 is None else u0.to(b.dtype)
        x_l, iters = solve_shard(node_block(u0, sg, mesh.coords),
                                 elem_block(rho.to(prob.force.dtype), sg, mesh.coords),
                                 node_block(b, sg, mesh.coords))
        return gather_field(mesh, x_l, overlap=True), iters

    where = "CUDA kernels" if use and prob.device.type == "cuda" else (
        "the kernel wrappers' plain twins" if use else "plain torch ops")
    solve.description = (
        f"sharded MGPCG over a {'x'.join(map(str, mesh.shape))} mesh of ranks "
        f"({mesh.route}), local grid {sg.local_grid.dims}: level 0 through {where}"
        + (" (fine_kernel=flat32)" if use else "")
        + ", Chebyshev smoothing, local Galerkin levels in torch ops")
    solve.mesh, solve.sharded_grid, solve.shard_solve = mesh, sg, solve_shard
    return solve


def make_sharded_solver(prob: FEMProblem, num_shards: int, num_levels: int,
                        tol: float = 1e-4, max_iter: int = 100,
                        mg_smoothing_iterations: int = 2, cheb_degree: int = 2,
                        mixed_precision: bool = True, use_kernels="auto",
                        mesh: Optional[Mesh] = None):
    """A ``(rho, u0) -> (u, iters)`` SolveFn over the slab decomposition
    on the ``num_shards`` ranks of the process group, a drop-in for the
    classic and neural drivers (``train_voxelfem --shards N``). Every
    rank calls it with the same global fields; each solves its slab, and
    the solution is all-gathered back. ``use_kernels``: "auto" (on for
    CUDA tensors of a degree-1 grid), True (CPU tensors take the twins)
    or False."""
    sg = ShardedGrid(global_grid=prob.grid, num_shards=num_shards)
    mesh = mesh or make_mesh(num_shards, prob.device)
    return _global_solver(prob, sg, mesh, make_sharded_mgpcg, num_levels, tol, max_iter,
                          mg_smoothing_iterations, cheb_degree, mixed_precision,
                          use_kernels)


def make_sharded_solver_2d(prob: FEMProblem, shards_x: int, shards_y: int,
                           num_levels: int, tol: float = 1e-4, max_iter: int = 100,
                           mg_smoothing_iterations: int = 2, cheb_degree: int = 2,
                           mixed_precision: bool = True, use_kernels="auto",
                           mesh: Optional[Mesh] = None):
    """The pencil twin of :func:`make_sharded_solver`
    (``train_voxelfem --shards NX,NY``)."""
    sg = ShardedGrid2D(global_grid=prob.grid, shards_x=shards_x, shards_y=shards_y)
    mesh = mesh or make_mesh_2d(shards_x, shards_y, prob.device)
    return _global_solver(prob, sg, mesh, make_sharded_mgpcg_2d, num_levels, tol,
                          max_iter, mg_smoothing_iterations, cheb_degree, mixed_precision,
                          use_kernels)
